"""The port's reader side (``io/loader.py``): the contracts of
``tests/test_loader.py`` on the CPU (``device="cpu"``; on the card each
leaf goes through pinned memory and a copy stream, ``tests/test_torch_gpu.py``),
with a ``Placement`` over ``["cpu"] * 8`` in place of the JAX mesh sharding,
and shards of the JAX package's writer read by the port's loader."""

import threading
import time

import numpy as np
import pytest
import torch

from exciting_environments_tpu.io import ShardWriter as JShardWriter
from exciting_environments_torch.io import DeviceLoader, ShardIndex, ShardWriter, read_shard_lazy
from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh
from exciting_environments_torch.parallel.mesh import batch_sharding, replicated_sharding

CPU = dict(device="cpu")


def _write(path, n_entries, shape=(16, 4), writer=ShardWriter):
    expected = []
    with writer(path, use_native=False) as w:
        for i in range(n_entries):
            arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 100 * i
            w.append({"obs": arr, "meta": np.full((3,), i, np.int32)}, name=f"e{i}")
            expected.append(arr)
    return expected


def test_shard_index_lazy_views(tmp_path):
    p = tmp_path / "a.extpu"
    expected = _write(p, 4)
    with ShardIndex(p) as idx:
        assert len(idx) == 4
        assert idx.names == [f"e{i}" for i in range(4)]
        name, arrays = idx.entry(2)
        assert name == "e2"
        np.testing.assert_array_equal(arrays["['obs']"], expected[2])
        # zero-copy: the view is backed by the mmap, not an owned buffer
        assert not arrays["['obs']"].flags["OWNDATA"]
    # materializing generator survives index closure
    out = list(read_shard_lazy(p))
    np.testing.assert_array_equal(out[3][1]["['obs']"], expected[3])
    assert out[3][1]["['obs']"].flags["OWNDATA"]


def test_shard_index_rejects_truncated(tmp_path):
    p = tmp_path / "a.extpu"
    _write(p, 2)
    data = p.read_bytes()
    (tmp_path / "trunc.extpu").write_bytes(data[:-5])
    with pytest.raises(ValueError, match="EXTPU1"):
        ShardIndex(tmp_path / "trunc.extpu")


@pytest.mark.parametrize("jax_writer", [False, True], ids=["port_shards", "jax_shards"])
def test_device_loader_roundtrip_order(tmp_path, jax_writer):
    writer = JShardWriter if jax_writer else ShardWriter
    paths = [tmp_path / "a.extpu", tmp_path / "b.extpu"]
    expected = _write(paths[0], 3, writer=writer) + _write(paths[1], 2, writer=writer)
    loader = DeviceLoader(paths, prefetch=2, **CPU)
    assert len(loader) == 5
    seen = list(loader)
    assert [n for n, _ in seen] == ["e0", "e1", "e2", "e0", "e1"]
    for (name, batch), exp in zip(seen, expected):
        assert isinstance(batch["['obs']"], torch.Tensor) and batch["['obs']"].device.type == "cpu"
        assert batch["['meta']"].dtype == torch.int32
        np.testing.assert_array_equal(batch["['obs']"].numpy(), exp)


def test_device_loader_mesh_placement(tmp_path):
    """A ``Placement`` over the mesh, split or replicated, puts every leaf on
    the mesh's first device, where a ``ShardedEnv`` keeps whole trees and
    splits them at each call; a callable chooses per leaf."""
    import exciting_environments_torch as P

    p = tmp_path / "a.extpu"
    expected = _write(p, 2, shape=(8, 6))
    mesh = make_batch_mesh(["cpu"] * 8)
    for sharding in (batch_sharding(mesh), replicated_sharding(mesh), lambda k, a: "cpu" if "obs" in k else None,
                     torch.device("cpu"), "cpu"):
        seen = list(DeviceLoader([p], sharding=sharding, **CPU))
        assert len(seen) == 2
        for (name, batch), exp in zip(seen, expected):
            obs = batch["['obs']"]
            assert obs.device == mesh.devices[0] and batch["['meta']"].device.type == "cpu"
            np.testing.assert_array_equal(obs.numpy(), exp)
    # loaded batches drop straight into a ShardedEnv consumer
    senv = ShardedEnv(P.Pendulum(batch_size=8, device="cpu", dtype=torch.float32), mesh)
    _, state = senv.vmap_reset(torch.Generator().manual_seed(0))
    for _, batch in DeviceLoader([p], sharding=batch_sharding(mesh), **CPU):
        acts = batch["['obs']"][:, :4, None].clamp(-1, 1)
        obs, _ = senv.vmap_rollout(state, acts, 4)
        assert obs.shape == (8, 1, 2) and bool(torch.isfinite(obs).all())


def test_device_loader_transform(tmp_path):
    p = tmp_path / "a.extpu"
    _write(p, 2)
    loader = DeviceLoader(
        [p], transform=lambda name, arrays: {k: v.astype(np.float16) for k, v in arrays.items()}, **CPU
    )
    for _, batch in loader:
        assert batch["['obs']"].dtype == torch.float16


def test_device_loader_propagates_errors(tmp_path):
    good = tmp_path / "good.extpu"
    _write(good, 1)
    bad = tmp_path / "bad.extpu"
    bad.write_bytes(b"garbage")
    it = iter(DeviceLoader([good, bad], **CPU))
    next(it)  # good entry arrives
    with pytest.raises(ValueError, match="EXTPU1"):
        for _ in it:
            pass


def test_device_loader_early_break_stops_worker(tmp_path):
    p = tmp_path / "a.extpu"
    _write(p, 3)
    before = {t.ident for t in threading.enumerate()}
    # prefetch >= remaining entries: the worker reaches its terminal put with
    # the queue full, which must also honor the stop flag
    for i, _ in enumerate(DeviceLoader([p], prefetch=2, **CPU)):
        break  # generator close must not deadlock or leak the worker
    deadline = time.time() + 5.0
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate() if t.ident not in before]
        if not leaked:
            return
        time.sleep(0.05)
    raise AssertionError(f"worker thread leaked: {leaked}")


def test_device_loader_never_picks_the_cpu_on_its_own(tmp_path):
    """Without a device the loader targets ``cuda:0``; without CUDA it
    raises at construction, before any entry is read."""
    p = tmp_path / "a.extpu"
    _write(p, 1)
    if torch.cuda.is_available():
        (_, batch), = list(DeviceLoader([p]))
        assert batch["['obs']"].device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceLoader([p])
    with pytest.raises(ValueError, match="prefetch"):
        DeviceLoader([p], prefetch=0, **CPU)
