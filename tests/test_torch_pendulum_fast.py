"""The port's speed-of-light pendulum rollout (``ops/kernels/pendulum_fast.py``
on CPU tensors, where it runs the plain version) against the JAX package's
Pallas kernel in interpret mode.

Same numpy inputs on both sides, float32 (the kernel's only type), B = 128,
T = 64.  Tolerance: angles compared modulo 2 pi within 1e-6 rad, omega
within 1e-6 (observed: 2.4e-7 and 1.2e-7, one or two float32 ulps; XLA's CPU
backend contracts multiply-add chains into FMAs, PyTorch eager does not, so
the result is not bitwise).  The kernel itself runs only on a CUDA card:
tests/test_torch_gpu.py holds it against this plain version there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas.pendulum_fast import pendulum_fast_rollout as j_fast
from exciting_environments_torch.ops.kernels import pendulum_fast as PFK
from exciting_environments_torch.utils.convert import state_from_numpy

TOL = 1e-6


def _pair(batch, **kwargs):
    return (J.Pendulum(batch_size=batch, tau=1e-4, **kwargs),
            P.Pendulum(batch_size=batch, tau=1e-4, device="cpu", dtype=torch.float32, **kwargs))


def _states(je, pe, seed):
    rng = np.random.default_rng(seed)
    x0 = {"theta": rng.uniform(-3.0, 3.0, pe.batch_size), "omega": rng.uniform(-5.0, 5.0, pe.batch_size)}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v, jnp.float32))
    return js, state_from_numpy(pe, x0)


def _actions(seed, batch, n):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (batch, n, 1)).astype(np.float32)


def test_plain_version_matches_the_pallas_kernel_in_interpret_mode():
    B, T = 128, 64
    je, pe = _pair(B, static_params={"l": 0.8, "m": 1.3, "g": 9.81})
    js, ps = _states(je, pe, 0)
    acts = _actions(1, B, T)
    th_j, om_j = j_fast(je, js, jnp.asarray(acts), chunk=8, interpret=True)
    th, om = P.pendulum_fast_rollout(pe, ps, torch.as_tensor(acts), chunk=8)
    assert th.dtype == om.dtype == torch.float32 and tuple(th.shape) == (B,)
    d = np.abs(np.remainder(th.numpy() - np.asarray(th_j) + math.pi, 2 * math.pi) - math.pi)
    assert d.max() < TOL
    np.testing.assert_allclose(om.numpy(), np.asarray(om_j), rtol=0, atol=TOL)
    assert float(th.abs().max()) <= math.pi + 1e-6


def test_time_major_and_batch_major_are_identical():
    B, T = 128, 32
    _, pe = _pair(B)
    _, state = pe.vmap_reset(rng=torch.Generator().manual_seed(2))
    acts = torch.as_tensor(_actions(3, B, T))
    bm = P.pendulum_fast_rollout(pe, state, acts)
    tm = P.pendulum_fast_rollout(pe, state, acts.transpose(0, 1).contiguous(), time_major=True)
    assert torch.equal(bm[0], tm[0]) and torch.equal(bm[1], tm[1])


def test_any_batch_and_horizon_run_and_chunk_has_no_effect():
    """No batch % 128 or T % chunk condition: a ragged B and a T that is not a
    multiple of chunk run, and chunk does not change the result."""
    B, T = 77, 13
    _, pe = _pair(B)
    _, state = pe.vmap_reset(rng=torch.Generator().manual_seed(4))
    acts = torch.as_tensor(_actions(5, B, T))
    a = P.pendulum_fast_rollout(pe, state, acts, chunk=8)
    b = P.pendulum_fast_rollout(pe, state, acts, chunk=16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert tuple(a[0].shape) == (B,) and bool(torch.isfinite(a[0]).all())
    # the loop is the plain version itself
    c = PFK.fast_constants(pe)
    th, om = PFK.plain_pendulum_fast_rollout(state.physical_state.theta, state.physical_state.omega,
                                             acts[..., 0].transpose(0, 1), **c)
    assert torch.equal(th, a[0]) and torch.equal(om, a[1])


def test_float64_state_runs_in_float32():
    B, T = 16, 8
    pe = P.Pendulum(batch_size=B, device="cpu", dtype=torch.float64)
    _, state = pe.vmap_reset(rng=torch.Generator().manual_seed(6))
    th, om = P.pendulum_fast_rollout(pe, state, torch.zeros((B, T, 1), dtype=torch.float64))
    assert th.dtype == om.dtype == torch.float32


def test_per_batch_parameters_and_bad_shapes_raise():
    B = 8
    pe = P.Pendulum(batch_size=B, device="cpu", static_params={"l": np.linspace(1.0, 2.0, B), "m": 1.0, "g": 9.81})
    _, state = pe.vmap_reset()
    with pytest.raises(ValueError, match="per-batch"):
        P.pendulum_fast_rollout(pe, state, torch.zeros((B, 4, 1)))
    pe = P.Pendulum(batch_size=B, device="cpu")
    _, state = pe.vmap_reset()
    with pytest.raises(ValueError, match="actions"):
        P.pendulum_fast_rollout(pe, state, torch.zeros((B, 4, 2)))
    with pytest.raises(ValueError, match="instances"):
        P.pendulum_fast_rollout(pe, state, torch.zeros((B + 1, 4, 1)))
