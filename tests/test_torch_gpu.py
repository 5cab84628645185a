"""The stepper kernel against its plain version on a CUDA card.

The kernel has no CPU mode, so these tests carry the ``gpu`` marker and skip
without a card.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with the JAX-free conftest skipped:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops.kernels import stepper as K

CASES = [
    ("Pendulum", "euler", 1, False),
    ("CartPole", "tsit5", 1, False),
    ("MassSpringDamper", "rk4", 1, False),
    ("Pendulum", "rk4", 1, True),
    ("CartPole", "rk4", 2, True),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stepper kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name,solver,hold,sim_ahead", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_version(name, solver, hold, sim_ahead, dtype):
    _cuda()
    env = getattr(P, name)(batch_size=4096 + 77, solver=solver, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    y0 = tuple((torch.rand(env.batch_size, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1).to(dtype)
               for _ in env._ode_state_fields)
    acts = (torch.rand((32 // hold, env.batch_size, 1), generator=gen, device="cuda", dtype=torch.float64)
            * 1.8 - 0.9).to(dtype)
    kw = dict(tau=env.tau, obs_stride=4, sim_ahead=sim_ahead, hold=hold)
    before = dict(K.KERNEL.launches)
    yk, tk = K.kernel_rollout(env, y0, acts, **kw)
    yp, tp = K.plain_rollout(env, y0, acts, **kw)
    torch.cuda.synchronize()
    mode = "sim_ahead" if sim_ahead else "step"
    assert K.KERNEL.launches[mode] == before[mode] + 1
    for a, b in zip(yk + tk, yp + tp):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_do():
    _cuda()
    env = P.Pendulum(batch_size=256)
    y0 = (torch.zeros(256, device="cuda"), torch.zeros(256, device="cuda"))
    acts = torch.zeros((8, 256, 1), device="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        K.kernel_rollout(env, y0, acts.clone().requires_grad_(True), tau=env.tau)
    with pytest.raises(ValueError, match="float32"):
        K.kernel_rollout(env, y0, acts.double(), tau=env.tau)
    obs, _ = env.fused_rollout(env.vmap_reset()[1], acts.transpose(0, 1), strict=True)
    assert obs.is_cuda and bool(torch.isfinite(obs).all())


@pytest.mark.gpu
def test_golden_pendulum_fixture_through_kernel_float64():
    _cuda()
    from pathlib import Path

    from exciting_environments_torch.utils import load_sim_properties_from_json

    data = Path(__file__).parent / "envs" / "pendulum" / "data"
    params, an, pn, tau = load_sim_properties_from_json(data / "sim_properties.json")
    env = P.Pendulum(batch_size=1, tau=tau, static_params=params, physical_normalizations=pn,
                     action_normalizations=an, dtype=torch.float64)
    stored = torch.as_tensor(np.load(data / "observations.npy"), device="cuda")
    actions = torch.as_tensor(np.load(data / "actions.npy"), device="cuda")
    state = env.generate_state_from_observation(stored[0][None], env.env_properties)
    obs, _ = env.fused_rollout(state, actions[None], obs_stride=1, strict=True)
    generated = torch.cat([stored[:1], obs[0]], dim=0)
    assert torch.allclose(generated, stored, 1e-16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_scalar_division_is_a_reciprocal_multiply(dtype):
    """The kernel reproduces PyTorch's CUDA eager division by a Python number:
    a multiply by the reciprocal taken in double and rounded to the working
    type.  If a PyTorch release changes that, this test says so first."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.rand(1 << 16, generator=gen, device="cuda", dtype=torch.float64) * 8 - 4).to(dtype)
    for c in (1.1, 0.05, 0.3):
        assert torch.equal(x / c, x * torch.tensor(1.0 / c, dtype=dtype, device="cuda"))
