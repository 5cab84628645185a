"""Controller training through the closed loops (``utils/train.py``) on CPU
tensors, against the JAX package.

The port's ``train_policy`` (``Adam(lr=0.1)``, each iteration's gradient from
the closed loop's checkpointed VJP) against a JAX reference loop:
``optax.adam(0.1)`` over ``jax.value_and_grad`` of the JAX package's scan
loss (``utils/collect.py::tile_policy_scan`` and its
``default_tracking_loss``), with the best-iterate rule of its
``utils/train.py:186-199``.  Float64, the same numpy inputs on both sides;
the per-iteration losses, the final loss and the returned parameters agree
to rtol 1e-8.  Then the scope tests of tests/test_train.py that apply to the
port, and the parameter-tree converters.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_tpu.utils.train import default_tracking_loss as j_default_tracking_loss
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.utils.convert import (
    actor_params_from_numpy,
    actor_params_to_numpy,
    state_from_numpy,
    tree_from_numpy,
    tree_to_numpy,
)
from exciting_environments_torch.utils.train import TrainResult, default_tracking_loss, train_policy

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-8
ITERATIONS = 4


def _jax_state(je, x0, refs):
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in refs.items():
            setattr(js.reference, n, jnp.asarray(v))
    return js


def _jax_train(je, js, law, params, n_steps, iterations, policy_carry=None, loss_fn=None):
    """The JAX package's train_policy loop over its scan path: optax.adam(0.1),
    the loss of each iteration at its pre-update parameters, the best
    iterate kept when it beats the final loss."""
    loss_fn = loss_fn or j_default_tracking_loss(je)

    def loss(p):
        out = j_tile_policy_scan(je, js, n_steps, law, p, True, policy_carry=policy_carry)
        return loss_fn(out[0], out[1])

    optimizer = optax.adam(0.1)
    vg = jax.jit(jax.value_and_grad(loss))
    opt_state = optimizer.init(params)
    losses, best = [], (None, float("inf"))
    for _ in range(iterations):
        value, grads = vg(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        v = float(value)
        losses.append(v)
        if v < best[1]:
            best = (params, v)
        params = new_params
    final_loss = float(jax.jit(loss)(params))
    if best[1] < final_loss and best[0] is not None:
        params, final_loss = best
    return params, np.asarray(losses), final_loss


def _pendulum_pair(n):
    rng = np.random.default_rng(0)
    x0 = {"theta": rng.uniform(-1, 1, n), "omega": rng.uniform(-1, 1, n)}
    refs = {"theta": np.linspace(-1.2, 1.2, n)}
    je = J.Pendulum(batch_size=n, tau=1e-2, control_state=["theta"])
    pe = P.Pendulum(batch_size=n, tau=1e-2, control_state=["theta"], **F64)
    return je, _jax_state(je, x0, refs), pe, state_from_numpy(pe, x0, reference=refs)


def _pd(obs, t, p):
    return (-p["kp"] * (obs[0] - obs[2]) - p["kd"] * obs[1],)


def _pi(obs, t, carry, p):
    e = obs[2] - obs[0]
    integ = carry[0] + p["ki"] * e
    return (p["kp"] * e + integ - 0.2 * obs[1],), (integ,)


def _affine(obs, t, p):
    """``AffinePolicy``'s law over the flat gains ``[K (1, 3), b]``, summed
    in its order."""
    return (p[3] + p[0] * obs[0] + p[1] * obs[1] + p[2] * obs[2],)


def _affine_pi(obs, t, carry, p):
    c = carry[0] + p[4] * obs[0] + p[5] * obs[1] + p[6] * obs[2]
    return (p[3] + p[0] * obs[0] + p[1] * obs[1] + p[2] * obs[2] + c,), (c,)


def _pmsm_pair(n):
    je = J.PMSM(batch_size=n, saturated=True, motor_variant=J.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    pe = P.PMSM(batch_size=n, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"], **F64)
    rng = np.random.default_rng(1)
    norms = pe.env_properties.physical_normalizations
    x0 = {"u_d_buffer": np.zeros(n), "u_q_buffer": np.zeros(n), "epsilon": rng.uniform(-math.pi, math.pi, n),
          "i_d": rng.uniform(-100, 0, n), "i_q": rng.uniform(-100, 100, n),
          "omega_el": rng.uniform(0, 0.3 * norms.omega_el.max, n)}
    x0["torque"] = pe._torque(torch.as_tensor(x0["i_d"]), torch.as_tensor(x0["i_q"]), pe.env_properties).numpy()
    refs = {"i_d": np.linspace(-200.0, -10.0, n), "i_q": np.linspace(-150.0, 150.0, n)}
    return je, _jax_state(je, x0, refs), pe, state_from_numpy(pe, x0, reference=refs)


def _pmsm_p(obs, t, p):
    return (-p["kd"] * (obs[0] - obs[8]), -p["kq"] * (obs[1] - obs[9]))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=RTOL,
                               atol=0)


CASES = ["pd-callable", "pd-AffinePolicy", "pi-callable", "pi-AffinePolicy", "pmsm-p-callable"]


@pytest.mark.parametrize("case", CASES)
def test_train_policy_matches_jax_reference_loop(case):
    carry_t = carry_j = None
    if case.startswith("pmsm"):
        je, js, pe, ps = _pmsm_pair(32)
        n_steps, law_j, law_p = 16, _pmsm_p, _pmsm_p
        params = {"kd": 0.3, "kq": 0.3}
    else:
        je, js, pe, ps = _pendulum_pair(64)
        n_steps = 24
        if case == "pd-callable":
            law_j, law_p, params = _pd, _pd, {"kp": 0.1, "kd": 0.0}
        elif case == "pi-callable":
            law_j, law_p, params = _pi, _pi, {"kp": 0.1, "ki": 0.0}
        elif case == "pd-AffinePolicy":
            law_j, law_p = _affine, P.AffinePolicy([[-0.1, 0.0, 0.1]])
            params = np.array([-0.1, 0.0, 0.1, 0.0])
        else:
            law_j, law_p = _affine_pi, P.AffinePolicy([[-0.1, 0.0, 0.1]], Ki=[[0.0, 0.0, 0.0]])
            params = np.array([-0.1, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0])
        if case.startswith("pi"):
            c0 = np.zeros(64)
            carry_j, carry_t = (jnp.asarray(c0),), (torch.as_tensor(c0),)
    p_j, losses_j, final_j = _jax_train(je, js, law_j, jax.tree_util.tree_map(jnp.asarray, params), n_steps,
                                        ITERATIONS, policy_carry=carry_j)
    res = train_policy(pe, law_p, tree_from_numpy(params, device="cpu"), ps, n_steps=n_steps, iterations=ITERATIONS,
                       policy_carry=carry_t)
    assert isinstance(res, TrainResult) and res.losses.shape == (ITERATIONS,)
    _close(res.losses.numpy(), losses_j)
    _close(res.final_loss, final_j)
    got, want = tree_to_numpy(res.params), jax.tree_util.tree_map(np.asarray, p_j)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w)
    assert res.final_loss <= float(res.losses[0])
    assert res.final_loss == min(float(res.losses.min()), res.final_loss)


def test_train_policy_takes_an_optimizer_factory_and_leaves_params_alone():
    _, _, pe, ps = _pendulum_pair(16)
    params = {"kp": torch.tensor(0.1, dtype=torch.float64), "kd": torch.tensor(0.0, dtype=torch.float64)}
    res = train_policy(pe, _pd, params, ps, n_steps=8, iterations=3,
                       optimizer=lambda ps_: torch.optim.SGD(ps_, lr=0.5))
    assert float(params["kp"]) == 0.1 and not params["kp"].requires_grad
    assert not res.params["kp"].requires_grad and float(res.params["kp"]) != 0.1
    assert bool(torch.isfinite(res.losses).all())


# ---------------------------------------------------------------------------
# scope (tests/test_train.py)
# ---------------------------------------------------------------------------


def test_train_policy_out_of_scope_raises():
    """A per-batch action band is out of the closed-loop kernel's scope, and
    training has no scan fallback."""
    env = P.Pendulum(batch_size=8, control_state=["theta"],
                     action_normalizations={"torque": P.MinMaxNormalization(min=-20, max=np.full(8, 30.0))}, **F64)
    _, s0 = env.vmap_reset()
    with pytest.raises(ValueError, match="scope"):
        train_policy(env, _pd, {"kp": torch.tensor(0.1), "kd": torch.tensor(0.0)}, s0, n_steps=4, iterations=1)


def test_default_tracking_loss_requires_control_state():
    with pytest.raises(ValueError, match="control_state"):
        default_tracking_loss(P.Pendulum(batch_size=8, **F64))


def test_pmsm_obs_description_matches_observation_columns():
    """The description list pairs names with generate_observation's real
    columns (reference pmsm_env.py:258-267 vs :903-916 disagree)."""
    n = 8
    env = P.PMSM(batch_size=n, control_state=["torque"], **F64)
    _, s0 = env.vmap_reset()
    eps = torch.linspace(0.1, 2.9, n, dtype=torch.float64)
    torque = torch.linspace(-5.0, 5.0, n, dtype=torch.float64)
    s0 = structures.replace(s0, physical_state=structures.replace(s0.physical_state, epsilon=eps, torque=torque),
                            reference=structures.replace(s0.reference, torque=torch.zeros(n, dtype=torch.float64)))
    obs = env.generate_observation(s0, env.env_properties)
    names = list(env.obs_description)
    np.testing.assert_allclose(obs[:, names.index("cos_eps")].numpy(), torch.cos(eps).numpy(), rtol=1e-12)
    np.testing.assert_allclose(obs[:, names.index("sin_eps")].numpy(), torch.sin(eps).numpy(), rtol=1e-12)
    lim = env.env_properties.physical_normalizations.torque
    np.testing.assert_allclose(obs[:, names.index("torque")].numpy(),
                               (2 * (torque - lim.min) / (lim.max - lim.min) - 1).numpy(), rtol=1e-12)
    assert names[-1] == "torque_ref"


def test_default_tracking_loss_pmsm_torque_pairs_real_column():
    """With references equal to the actual torque the loss is ~0 (a pairing
    by the reference's description order would read sin_eps)."""
    n = 8
    env = P.PMSM(batch_size=n, control_state=["torque"], **F64)
    _, s0 = env.vmap_reset()
    torque = torch.linspace(-5.0, 5.0, n, dtype=torch.float64)
    s0 = structures.replace(
        s0, physical_state=structures.replace(s0.physical_state, epsilon=torch.linspace(0.3, 2.5, n,
                                                                                        dtype=torch.float64),
                                              torque=torque),
        reference=structures.replace(s0.reference, torque=torque))
    obs = env.generate_observation(s0, env.env_properties)[:, None, :]
    assert float(default_tracking_loss(env)(obs, None)) < 1e-12


def test_plain_callable_on_a_cuda_environment_raises_before_a_launch():
    _, _, pe, ps = _pendulum_pair(8)
    pe.device = torch.device("cuda")  # the device check only: nothing is allocated there
    CL.CL_KERNEL.reset_counts()
    with pytest.raises(ValueError, match="plain callable"):
        train_policy(pe, _pd, {"kp": torch.tensor(0.1), "kd": torch.tensor(0.0)}, ps, n_steps=4, iterations=1)
    assert CL.CL_KERNEL.launches == {"closed_loop": 0}


def test_second_derivative_through_the_training_loss_raises():
    _, _, pe, ps = _pendulum_pair(8)
    gains = P.AffinePolicy([[-0.9, -0.25, 0.9]]).flat_params().clone().requires_grad_(True)
    obs, _, _ = pe.fused_closed_loop(ps, P.AffinePolicy([[0.0, 0.0, 0.0]]), 6, obs_stride=1, policy_params=gains)
    (g,) = torch.autograd.grad(default_tracking_loss(pe)(obs, None), [gains], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()


# ---------------------------------------------------------------------------
# parameter trees across the packages
# ---------------------------------------------------------------------------


def test_parameter_trees_round_trip():
    tree = {"kp": 0.5, "gains": [np.arange(3.0), (np.ones((2, 2)), 2.0)]}
    t = tree_from_numpy(tree, torch.float32, "cpu")
    assert t["gains"][1][0].dtype == torch.float32 and isinstance(t["gains"][1], tuple)
    back = tree_to_numpy(t)
    assert back["gains"][0].dtype == np.float64
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_actor_params_round_trip():
    rng = np.random.default_rng(3)
    tree = {"actor": [{"w": rng.normal(size=(3, 16)), "b": rng.normal(size=16)},
                      {"w": rng.normal(size=(16, 1)), "b": rng.normal(size=1)}],
            "log_std": np.full(1, -1.0), "seed": np.float64(7.0)}
    env = P.Pendulum(batch_size=4, control_state=["theta"], **F64)
    back = actor_params_to_numpy(actor_params_from_numpy(env, tree))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
