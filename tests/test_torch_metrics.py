"""The port's streaming and windowed fleet metrics (``parallel/metrics.py``)
against numpy and the JAX package's, on CPU tensors in float64.

The six cases of ``tests/test_metrics.py``, and ``across_mesh`` against the
JAX package's ``across_mesh`` under ``shard_map`` on the conftest's 8
virtual devices: the same per-shard data, the same Chan formula, count,
mean and M2 within 1e-12 relative (the per-shard sums reduce in another
order than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exciting_environments_tpu.parallel import metrics as jm
from exciting_environments_torch.parallel import metrics as pm
from exciting_environments_torch.parallel.metrics import (
    across_mesh,
    merge,
    running_init,
    running_summary,
    running_update,
    window_init,
    window_max,
    window_mean,
    window_min,
    window_push,
)

F64 = dict(device="cpu", dtype=torch.float64)


def test_running_stats_matches_numpy():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(3.0, 2.0, size=(257,)) for _ in range(5)]
    stats = running_init(**F64)
    for c in chunks:
        stats = running_update(stats, torch.as_tensor(c))
    s = running_summary(stats)
    all_v = np.concatenate(chunks)
    assert int(s["count"]) == all_v.size
    np.testing.assert_allclose(float(s["mean"]), all_v.mean(), rtol=1e-12)
    np.testing.assert_allclose(float(s["std"]), all_v.std(), rtol=1e-10)
    assert float(s["min"]) == all_v.min() and float(s["max"]) == all_v.max()


def test_running_stats_vector_metrics():
    """Per-metric leading dims: one accumulator tracking (3,) metrics."""
    rng = np.random.default_rng(1)
    data = rng.normal(size=(64, 3))
    stats = running_update(running_init(shape=(3,), **F64), torch.as_tensor(data), axis=(0,))
    s = running_summary(stats)
    np.testing.assert_allclose(s["mean"].numpy(), data.mean(0), rtol=1e-12)
    np.testing.assert_allclose(s["std"].numpy(), data.std(0), rtol=1e-10)


def test_pairwise_merge_associative():
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=(100,)) for _ in range(3))
    sa, sb, sc = (running_update(running_init(**F64), torch.as_tensor(x)) for x in (a, b, c))
    left = merge(merge(sa, sb), sc)
    right = merge(sa, merge(sb, sc))
    np.testing.assert_allclose(float(left.mean), float(right.mean), rtol=1e-12)
    np.testing.assert_allclose(float(left.m2), float(right.m2), rtol=1e-10)
    # merging with an empty accumulator is the identity
    assert float(merge(sa, running_init(**F64)).mean) == float(sa.mean)


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_across_mesh_matches_global_and_jax(layout):
    """Eight per-shard accumulators merge into the global statistics, equal
    to the JAX package's ``psum`` merge on the same shards."""
    from jax.sharding import Mesh, PartitionSpec as PS

    rng = np.random.default_rng(3)
    data = rng.normal(5.0, 1.5, size=(8, 500))
    shards = [running_update(running_init(**F64), torch.as_tensor(row)) for row in data]
    if layout == "stacked":
        shards = pm._stacked(shards)
    out = across_mesh(shards)
    s = running_summary(out)
    np.testing.assert_allclose(float(s["mean"]), data.mean(), rtol=1e-12)
    np.testing.assert_allclose(float(s["std"]), data.std(), rtol=1e-10)
    assert int(s["count"]) == data.size

    def local(values):
        return jm.across_mesh(jm.running_update(jm.running_init(dtype=jnp.float64), values), "batch")

    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    ref = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=PS("batch"), out_specs=PS()))(
        jnp.asarray(data.reshape(-1)))
    for name in ("count", "mean", "m2", "min", "max"):
        np.testing.assert_allclose(float(getattr(out, name)), float(getattr(ref, name)), rtol=1e-12, err_msg=name)


def test_window_ring_buffer():
    w = window_init(4, **F64)
    for v in (1.0, 2.0, 3.0):
        w = window_push(w, v)
    assert float(window_mean(w)) == 2.0 and float(window_min(w)) == 1.0
    for v in (4.0, 5.0):  # wraps: window is now (2, 3, 4, 5)
        w = window_push(w, v)
    assert float(window_mean(w)) == 3.5
    assert float(window_max(w)) == 5.0 and float(window_min(w)) == 2.0


def test_window_means_along_a_loop_match_jax():
    """The windowed mean after each of 20 pushes, against the JAX package's
    window threaded through ``lax.scan``: after 8 pushes the mean is the
    trailing-8 average."""
    def body(w, v):
        w = jm.window_push(w, v)
        return w, jm.window_mean(w)

    _, ref = jax.lax.scan(body, jm.window_init(8, dtype=jnp.float64), jnp.arange(20, dtype=jnp.float64))
    w, means = window_init(8, **F64), []
    for v in range(20):
        w = window_push(w, float(v))
        means.append(float(window_mean(w)))
    np.testing.assert_array_equal(np.array(means), np.asarray(ref))
    assert means[-1] == np.arange(12, 20).mean()


def test_one_shot_reductions_and_psum():
    trunc = torch.tensor([[True, False], [False, False], [False, True], [False, False]])
    assert float(pm.violation_fraction(trunc)) == 0.5 == float(jm.violation_fraction(jnp.asarray(trunc.numpy())))
    vals = torch.arange(8, dtype=torch.float64)
    assert float(pm.mean_metric(vals)) == 3.5 and float(pm.sum_metric(vals)) == 28.0
    reduce = pm.psum_across()
    assert torch.equal(reduce([vals[:4], vals[4:]]), vals[:4] + vals[4:])
    assert torch.equal(reduce(vals.reshape(2, 4)), vals[:4] + vals[4:])
    host = pm.gather_to_host(running_init(**F64))
    assert host.mean.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            running_init()
