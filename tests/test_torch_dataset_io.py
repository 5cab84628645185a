"""The port's shard writer (``io/dataset.py``, ``io/native.py``) against the
JAX package's: the contracts of ``tests/test_dataset_io.py`` on CPU tensors
(the native writer is built here with the host compiler), then across the
packages.

Across the packages, the same NumPy data goes into a JAX tree and a port
tree (a ``TrajectoryBatch``; a tracking Pendulum state with threefry keys
and a fresh state's ``active_solver_state``; a dict with unsorted keys, a
Python float and a 0-d leaf); each package writes its own shard with each of
its writers, and the two files must be equal byte for byte.  Each package
reads the other's shards, and the shard CLIs print the same lines for the
same shard (apart from the path).
"""

import contextlib
import io as pyio
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.io import ShardWriter as JShardWriter
from exciting_environments_tpu.io import read_shard as jread_shard
from exciting_environments_tpu.io.__main__ import main as jmain
from exciting_environments_tpu.utils.collect import TrajectoryBatch as JTrajectoryBatch
from exciting_environments_torch.io import ShardWriter, TorchShardDataset, read_shard
from exciting_environments_torch.io.__main__ import main as pmain
from exciting_environments_torch.io.dataset import _PyAsyncWriter
from exciting_environments_torch.io.native import BUILD_DIR, native_available
from exciting_environments_torch.utils.collect import RolloutCollector, TrajectoryBatch
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
BACKENDS = [False] + ([True] if native_available() else [])
IDS = ["python", "native"][: len(BACKENDS)]


@pytest.mark.parametrize("use_native", BACKENDS, ids=IDS)
def test_trajectory_shard_roundtrip(tmp_path, use_native):
    env = P.Pendulum(batch_size=8, **F64)
    gen = torch.Generator().manual_seed(0)
    _, state = env.vmap_reset(gen)
    collector = RolloutCollector(env)

    path = tmp_path / "run.extpu"
    trajs = []
    with ShardWriter(path, use_native=use_native) as w:
        assert w.native == use_native
        for i in range(3):
            actions = torch.rand((8, 10, 1), generator=gen, dtype=torch.float64) * 2 - 1
            traj, state = collector.collect(state, actions)
            trajs.append(traj)
            w.append(traj, name=f"rollout_{i}")

    entries = read_shard(path)
    assert [name for name, _ in entries] == ["rollout_0", "rollout_1", "rollout_2"]
    for (name, arrays), traj in zip(entries, trajs):
        np.testing.assert_array_equal(arrays["['observations']"], traj.observations.numpy())
        np.testing.assert_array_equal(arrays["['actions']"], traj.actions.numpy())
        np.testing.assert_array_equal(arrays["['rewards']"], traj.rewards.numpy())


def test_native_builds_and_reports_written(tmp_path):
    """The native writer builds from the package's own source into the
    package's build directory and reports the bytes it wrote."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    assert list(BUILD_DIR.glob("shard_writer_*.so"))
    w = ShardWriter(tmp_path / "x.extpu", use_native=True)
    w.append({"a": torch.arange(1000.0, dtype=torch.float64)})
    written = w.close()
    # magic + 8000 payload bytes + footer
    assert written > 8000
    (name, arrays), = read_shard(tmp_path / "x.extpu")
    np.testing.assert_array_equal(arrays["['a']"], np.arange(1000.0))


@pytest.mark.parametrize("use_native", BACKENDS, ids=IDS)
def test_many_appends_and_order(tmp_path, use_native):
    path = tmp_path / "many.extpu"
    with ShardWriter(path, use_native=use_native, max_queue_bytes=1 << 16) as w:
        for i in range(50):
            w.append({"x": torch.full((128,), float(i), dtype=torch.float32)})
    entries = read_shard(path)
    assert len(entries) == 50
    for i, (_, arrays) in enumerate(entries):
        assert float(arrays["['x']"][0]) == i  # order preserved under backpressure


def test_corrupt_file_rejected(tmp_path):
    p = tmp_path / "bad.extpu"
    p.write_bytes(b"not a shard at all")
    with pytest.raises(ValueError, match="EXTPU1"):
        read_shard(p)


def test_python_writer_surfaces_io_errors(tmp_path):
    """A drain-thread disk error raises at the producer, not silently
    truncating the shard."""
    w = _PyAsyncWriter(tmp_path / "x.bin", max_queue_bytes=1 << 20)

    class _FailingFile:
        def write(self, buf):
            raise OSError("disk full")

        def close(self):
            pass

    w._f.close()
    w._f = _FailingFile()
    with pytest.raises(OSError, match="IO error"):
        for _ in range(100):
            w.write(b"x" * 1024)
            time.sleep(0.01)
    with pytest.raises(OSError, match="IO error"):
        w.close()


def test_python_writer_backpressure_bounded(tmp_path):
    """pending() stays within max_queue_bytes (plus one in-flight buffer)."""

    class _SlowFile:
        def __init__(self, f):
            self._f = f

        def write(self, buf):
            time.sleep(0.002)
            return self._f.write(buf)

        def close(self):
            self._f.close()

    w = _PyAsyncWriter(tmp_path / "slow.bin", max_queue_bytes=4096)
    w._f = _SlowFile(w._f)
    maxima = 0
    for _ in range(30):
        w.write(b"x" * 1024)
        maxima = max(maxima, w.pending())
    assert maxima <= 4096 + 1024, f"backpressure bound violated: {maxima}"
    assert w.close() == 30 * 1024

    # a single oversized buffer is admitted rather than deadlocking
    w2 = _PyAsyncWriter(tmp_path / "big.bin", max_queue_bytes=16)
    w2.write(b"y" * 4096)
    assert w2.close() == 4096


def test_torch_shard_dataset(tmp_path):
    """Shards load as a standard map-style torch dataset; DataLoader batches
    stack records; transform hooks build training pairs."""
    from torch.utils.data import DataLoader

    paths = []
    for s in range(2):
        p = str(tmp_path / f"shard_{s}.extpu")
        with ShardWriter(p, use_native=False) as w:
            for k in range(3):
                w.append(
                    {"obs": torch.full((4, 2), float(10 * s + k)), "act": torch.full((4, 1), float(k))},
                    name=f"chunk_{k}",
                )
        paths.append(p)

    with TorchShardDataset(paths) as ds:
        assert isinstance(ds, torch.utils.data.Dataset)
        assert len(ds) == 6
        assert ds.names[0] == "chunk_0" and len(ds.names) == 6
        item = ds[4]  # shard 1, record 1
        assert isinstance(item["obs"], torch.Tensor)
        assert item["obs"].shape == (4, 2) and float(item["obs"][0, 0]) == 11.0

        batches = list(DataLoader(ds, batch_size=3, shuffle=False))
        assert len(batches) == 2
        assert batches[0]["obs"].shape == (3, 4, 2)
        np.testing.assert_array_equal(
            batches[0]["act"][:, 0, 0].numpy(), np.asarray([0.0, 1.0, 2.0], np.float32)
        )

    def pair(name, tensors):
        return tensors["obs"], tensors["act"]

    with TorchShardDataset(paths[0], transform=pair) as ds2:
        x, y = ds2[0]
        assert x.shape == (4, 2) and y.shape == (4, 1)


def test_torch_dataset_is_picklable_for_spawned_workers(tmp_path):
    """DataLoader workers under spawn/forkserver pickle the dataset: only
    paths/transform are carried, shard maps reopen in the new process."""
    p = str(tmp_path / "shard.extpu")
    with ShardWriter(p, use_native=False) as w:
        w.append({"obs": torch.arange(8, dtype=torch.float32).reshape(4, 2)}, name="c0")

    with TorchShardDataset(p) as ds:
        clone = pickle.loads(pickle.dumps(ds))
        try:
            assert len(clone) == len(ds) == 1
            np.testing.assert_array_equal(clone[0]["obs"].numpy(), ds[0]["obs"].numpy())
            assert clone.names == ds.names
        finally:
            clone.close()


def test_bfloat16_leaf_raises_naming_it(tmp_path):
    """NumPy cannot name bfloat16 without ml_dtypes: the writer refuses the
    leaf by its path before writing anything of the record."""
    with ShardWriter(tmp_path / "b.extpu", use_native=False) as w:
        with pytest.raises(TypeError, match=r"\['half'\].*bfloat16"):
            w.append({"ok": torch.zeros(3), "half": torch.zeros(3, dtype=torch.bfloat16)})
    assert read_shard(tmp_path / "b.extpu") == []


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _trajectories():
    """Two TrajectoryBatch records of the same NumPy data (float64 and
    float32 leaves, boolean flags)."""
    rng = np.random.default_rng(0)
    out = []
    for dtype in (np.float64, np.float32):
        data = dict(observations=rng.normal(size=(4, 6, 3)).astype(dtype),
                    actions=rng.uniform(-1, 1, size=(4, 6, 1)).astype(dtype),
                    rewards=rng.normal(size=(4, 6, 1)).astype(dtype),
                    terminated=rng.uniform(size=(4, 6, 1)) < 0.3, truncated=rng.uniform(size=(4, 6, 1)) < 0.1)
        out.append((JTrajectoryBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
                    TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in data.items()})))
    return out


def _states():
    """A tracking Pendulum's reset state with threefry keys and the fresh
    state's solver flags, in each package from the same arrays."""
    B = 5
    je = J.Pendulum(batch_size=B, control_state=["theta"])
    pe = P.Pendulum(batch_size=B, control_state=["theta"], **F64)
    rng = np.random.default_rng(1)
    theta, omega, ref = rng.normal(size=B), rng.normal(size=B), rng.uniform(-1, 1, size=B)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    _, js = je.vmap_reset(keys)
    js = jstructures.replace(
        js,
        physical_state=jstructures.replace(js.physical_state, theta=jnp.asarray(theta), omega=jnp.asarray(omega)),
        reference=jstructures.replace(js.reference, theta=jnp.asarray(ref)),
    )
    ps = state_from_numpy(pe, {"theta": theta, "omega": omega}, reference={"theta": ref},
                          keys=np.asarray(js.PRNGKey))
    assert ps.additions.active_solver_state is False
    return [(js, ps)]


def _dicts():
    """A dict with unsorted keys, a Python float, a Python int, a 0-d leaf
    and an int32 leaf."""
    rng = np.random.default_rng(2)
    w, counts = rng.normal(size=(3, 2)), np.arange(4, dtype=np.int32)
    return [({"zeta": jnp.asarray(w), "alpha": 0.25, "mid": jnp.asarray(1.5), "count": 7, "ints": jnp.asarray(counts)},
             {"zeta": torch.as_tensor(w), "alpha": 0.25, "mid": torch.tensor(1.5, dtype=torch.float64), "count": 7,
              "ints": torch.as_tensor(counts)})]


CASES = {"trajectory": _trajectories, "state": _states, "dict": _dicts}


def _write_both(tmp_path, case, use_native):
    jpath, ppath = tmp_path / f"jax_{case}.extpu", tmp_path / f"port_{case}.extpu"
    pairs = CASES[case]()
    with JShardWriter(jpath, use_native=use_native) as jw, ShardWriter(ppath, use_native=use_native) as pw:
        assert jw.native == pw.native == use_native
        for i, (jtree, ptree) in enumerate(pairs):
            jw.append(jtree, name=f"{case}_{i}")
            pw.append(ptree, name=f"{case}_{i}")
    return jpath, ppath


@pytest.mark.parametrize("use_native", BACKENDS, ids=IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_write_the_same_bytes(tmp_path, case, use_native):
    jpath, ppath = _write_both(tmp_path, case, use_native)
    jbytes, pbytes = jpath.read_bytes(), ppath.read_bytes()
    assert len(jbytes) == len(pbytes) and jbytes == pbytes


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_shards(tmp_path, case):
    jpath, ppath = _write_both(tmp_path, case, use_native=BACKENDS[-1])
    for port_read, jax_read in ((read_shard(jpath), jread_shard(jpath)), (read_shard(ppath), jread_shard(ppath))):
        assert [n for n, _ in port_read] == [n for n, _ in jax_read]
        for (_, pa), (_, ja) in zip(port_read, jax_read):
            assert list(pa) == list(ja)
            for k in pa:
                assert pa[k].dtype == ja[k].dtype and pa[k].shape == ja[k].shape
                np.testing.assert_array_equal(pa[k], ja[k])
    # the dict's scalars as the JAX package writes them: (1,) arrays
    if case == "dict":
        (_, arrays), = read_shard(ppath)
        assert arrays["['alpha']"].shape == (1,) and arrays["['alpha']"].dtype == np.float64
        assert arrays["['mid']"].shape == (1,) and arrays["['count']"].dtype == np.int64
    if case == "state":
        (_, arrays), = read_shard(ppath)
        assert arrays["['PRNGKey']"].dtype == np.uint32
        assert arrays["['additions']['active_solver_state']"].shape == (5,)


def test_cli_prints_the_jax_lines(tmp_path):
    jpath, ppath = _write_both(tmp_path, "trajectory", use_native=False)
    outs = []
    for main, path in ((jmain, jpath), (pmain, ppath)):
        buf = pyio.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(path)]) == 0
        outs.append(buf.getvalue().splitlines())
    jlines, plines = outs
    assert jlines[0] == f"{jpath}: 2 records" and plines[0] == f"{ppath}: 2 records"
    assert jlines[1:] == plines[1:] and len(plines) == 4
    assert plines[-1].strip().startswith("payload:")
