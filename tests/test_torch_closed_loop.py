"""The port's closed loop (the closed-loop kernel's plain version on CPU
tensors) against the JAX package's closed-loop references.

Same numpy inputs on both sides, float64 on the CPU, B = 256, T = 12.  The
JAX references are its plain paths: ``utils.collect.tile_policy_scan`` (the
closed loop as a scan of ``env.step``) and ``ops.pallas.stepper._plain_cl_step``
(the kernel's per-step computation) in a loop, and once the Pallas kernel
itself in interpret mode (B = 1,024, T = 8).  Tolerance rtol = atol =
1e-10, the figure of tests/test_pallas_stepper.py's closed-loop tests (an
``AffinePolicy`` sums in another order than the JAX test's PD expression).
The kernel itself runs only on a CUDA card: tests/test_torch_gpu.py holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas import stepper as jstepper
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import closed_loop_path
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import state_from_numpy

TOL = dict(rtol=1e-10, atol=1e-10)
BATCH, T = 256, 12
F64 = dict(device="cpu", dtype=torch.float64)


def pd_pendulum(obs, t):
    """The PD tracking law of tests/test_pallas_stepper.py (JAX or torch)."""
    return (-0.9 * (obs[0] - obs[2]) - 0.25 * obs[1],)


def pd_cartpole(obs, t):
    return (-0.5 * (obs[0] - obs[4]) - 0.3 * obs[1] + 0.8 * obs[2] + 0.2 * obs[3],)


PD = {
    "Pendulum": (pd_pendulum, [[-0.9, -0.25, 0.9]], "theta"),
    "CartPole": (pd_cartpole, [[-0.5, -0.3, 0.8, 0.2, 0.5]], "deflection"),
}


def _pair(name, solver="euler", batch=BATCH, **kwargs):
    control = [PD[name][2]]
    return (getattr(J, name)(batch_size=batch, solver=solver, control_state=control, **kwargs),
            getattr(P, name)(batch_size=batch, solver=solver, control_state=control, **F64, **kwargs))


def _states(je, pe, seed):
    """The same initial state and tracking reference on both sides."""
    rng = np.random.default_rng(seed)
    x0 = {n: rng.uniform(-1.0, 1.0, pe.batch_size) for n in pe._ode_state_fields}
    refs = {n: rng.uniform(-1.5, 1.5, pe.batch_size) for n in pe.control_state}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in refs.items():
            setattr(js.reference, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0, reference=refs)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("name,solver", [("Pendulum", "euler"), ("Pendulum", "rk4"), ("CartPole", "tsit5")])
@pytest.mark.parametrize("as_module", [False, True], ids=["callable", "AffinePolicy"])
def test_pd_matches_jax_tile_policy_scan(name, solver, as_module):
    je, pe = _pair(name, solver)
    js, ps = _states(je, pe, 0)
    law, K, _ = PD[name]
    obs_j, acts_j, _, last_j = j_tile_policy_scan(je, js, T, law, None, True)
    policy = P.AffinePolicy(K) if as_module else law
    assert CL.supports_fused_closed_loop(pe)
    obs_p, acts_p, last_p = pe.fused_closed_loop(ps, policy, T, obs_stride=1)
    assert tuple(obs_p.shape) == (BATCH, T, len(pe.obs_description))
    assert tuple(acts_p.shape) == (BATCH, T, 1)
    _close(obs_p, obs_j)
    _close(acts_p, acts_j)
    field = pe._ode_state_fields[-2]
    _close(getattr(last_p.physical_state, field), getattr(last_j.physical_state, field))
    obs_fin, _ = pe.fused_closed_loop(ps, policy, T)
    _close(obs_fin, obs_j[:, -1])


def test_pi_with_carry_matches_jax():
    """A PI law with its integrator in the policy carry, the returned final
    carry included (rtol 1e-12, the JAX test's figure)."""
    je, pe = _pair("Pendulum")
    js, ps = _states(je, pe, 1)
    kp, ki, kd = 0.7, 0.08, 0.2

    def pi(obs, t, carry):
        e = obs[2] - obs[0]
        integ = carry[0] + ki * e
        return (kp * e + integ - kd * obs[1],), (integ,)

    obs_j, acts_j, _, last_j, fc_j = j_tile_policy_scan(je, js, T, pi, None, True,
                                                        policy_carry=(jnp.zeros(BATCH),))
    c0 = (torch.zeros(BATCH, dtype=torch.float64),)
    for policy in (pi, P.AffinePolicy([[-kp, -kd, kp]], Ki=[[-ki, 0.0, ki]])):
        obs_p, acts_p, last_p, fc_p = pe.fused_closed_loop(ps, policy, T, obs_stride=1, policy_carry=c0)
        _close(obs_p, obs_j)
        _close(acts_p, acts_j)
        _close(fc_p[0], fc_j[0], rtol=1e-12, atol=1e-12)
        _close(last_p.physical_state.theta, last_j.physical_state.theta)
        obs_fin, _, fc_fin = pe.fused_closed_loop(ps, policy, T, policy_carry=c0)
        _close(fc_fin[0], fc_j[0], rtol=1e-12, atol=1e-12)
        _close(obs_fin, obs_j[:, -1])


def test_affine_policy_clip_and_flat_params():
    """The clamp, and gains passed as the flat policy_params vector."""
    _, pe = _pair("Pendulum")
    _, ps = _states(*_pair("Pendulum"), 2)
    law = lambda obs, t: (torch.clamp(0.1 + -3.0 * obs[0] + -0.5 * obs[1] + 3.0 * obs[2], -0.4, 0.4),)
    fixed = P.AffinePolicy([[-3.0, -0.5, 3.0]], b=[0.1], clip=0.4)
    o_law, a_law, _ = pe.fused_closed_loop(ps, law, T, obs_stride=1)
    o_fix, a_fix, _ = pe.fused_closed_loop(ps, fixed, T, obs_stride=1)
    assert torch.equal(o_law, o_fix) and torch.equal(a_law, a_fix)
    assert float(a_fix.abs().max()) == 0.4
    free = P.AffinePolicy(np.zeros((1, 3)), clip=0.4)
    o_flat, a_flat, _ = pe.fused_closed_loop(ps, free, T, obs_stride=1, policy_params=fixed.flat_params())
    assert torch.equal(o_flat, o_fix) and torch.equal(a_flat, a_fix)


def test_fsal_final_state_structure_and_value():
    """Tsit5: the final state carries the FSAL solver carry.  With a
    trajectory it is f(y1) under the last saved action, as the scan's; in
    final-only mode under the policy's action at the FINAL state (the JAX
    quirk)."""
    je, pe = _pair("Pendulum", "tsit5")
    js, ps = _states(je, pe, 3)
    n = 8
    _, _, _, last_j = j_tile_policy_scan(je, js, n, pd_pendulum, None, True)
    _, _, last_traj = pe.fused_closed_loop(ps, pd_pendulum, n, obs_stride=1)
    _, last_fin = pe.fused_closed_loop(ps, pd_pendulum, n)
    _, reset_state = pe.vmap_reset()
    from exciting_environments_torch.core import structures

    assert structures.structure(last_traj) == structures.structure(reset_state)
    assert structures.structure(last_fin) == structures.structure(reset_state)
    for k_p, k_j in zip(last_traj.additions.solver_state, last_j.additions.solver_state):
        _close(k_p, k_j)
    # the final-only quirk, rebuilt from the JAX scan's final state
    obs_last = jax.vmap(je.generate_observation, in_axes=(0, je.in_axes_env_properties))(
        last_j, je.env_properties)
    a_last = pd_pendulum(tuple(obs_last[:, i] for i in range(3)), n - 1)[0]
    y_last = tuple(getattr(last_j.physical_state, f) for f in je._ode_state_fields)
    u_last = je.env_properties.action_normalizations.torque.denormalize(a_last)[:, None]
    quirk = jstepper._final_solver_state(je, y_last, u_last)
    for k_p, k_j in zip(last_fin.additions.solver_state, quirk):
        _close(k_p, k_j.reshape(-1))


def test_per_batch_params_and_policy_gradient_match_jax():
    """Per-batch pendulum lengths, and the gradient of the tracking loss in
    the policy parameters through the port's CPU path (autograd) against
    jax.grad of the scan loss, at 1e-9."""
    lengths = 1.0 + np.arange(BATCH) / BATCH
    je = J.Pendulum(batch_size=BATCH, control_state=["theta"],
                    static_params={"l": jnp.asarray(lengths), "g": 9.81, "m": 1})
    pe = P.Pendulum(batch_size=BATCH, control_state=["theta"], static_params={"l": lengths, "g": 9.81, "m": 1},
                    **F64)
    assert CL.supports_fused_closed_loop(pe)
    js, ps = _states(je, pe, 4)

    def law(obs, t, p):
        return (-p["kp"] * (obs[0] - obs[2]) - p["kd"] * obs[1],)

    def loss_j(p):
        obs, _, _, _ = j_tile_policy_scan(je, js, 10, law, p, True)
        return jnp.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2)

    p_j = {"kp": jnp.asarray(0.8), "kd": jnp.asarray(0.3)}
    p_t = {k: torch.tensor(float(v), dtype=torch.float64, requires_grad=True) for k, v in p_j.items()}
    obs_p, _, _ = pe.fused_closed_loop(ps, law, 10, obs_stride=1, policy_params=p_t)
    loss_p = torch.mean((obs_p[:, :, 0] - obs_p[:, :, 2]) ** 2)
    loss_p.backward()
    assert abs(float(loss_p.detach()) - float(loss_j(p_j))) <= 1e-10 * abs(float(loss_j(p_j)))
    g_j = jax.grad(loss_j)(p_j)
    for k in p_j:
        assert abs(float(p_t[k].grad) - float(g_j[k])) <= 1e-9 * abs(float(g_j[k])), k


@pytest.mark.parametrize("with_carry", [False, True])
def test_noise_slabs_match_jax_plain_cl_step(with_carry):
    """Injected sensor- and process-noise slabs through fused_closed_loop
    against the JAX kernel's per-step computation with the same slabs."""
    je, pe = _pair("Pendulum", "rk4")
    js, _ = _states(je, pe, 5)
    rng = np.random.default_rng(6)
    eo = 0.05 * rng.standard_normal((T, BATCH, 2))
    ep = 0.01 * rng.standard_normal((T, BATCH, 2))
    y0 = tuple(np.array(getattr(js.physical_state, n)) for n in pe._ode_state_fields)
    ref = np.array(je.env_properties.physical_normalizations.theta.normalize(js.reference.theta))
    pi = lambda obs, t, c: ((0.5 * (obs[2] - obs[0]) + c[0] - 0.2 * obs[1],), (c[0] + 0.05 * (obs[2] - obs[0]),))
    policy = pi if with_carry else pd_pendulum

    tile_ode, leaves = jstepper._batched_param_closure(je)
    norms = lambda d, names: tuple((float(getattr(d, n).min), float(getattr(d, n).max)) for n in names)
    step = jstepper._plain_cl_step(
        tile_ode, je._solver, policy, je.tau, (True, False), None,
        norms(je.env_properties.physical_normalizations, ("theta", "omega")),
        norms(je.env_properties.action_normalizations, ("torque",)), False, False, leaves,
        has_carry=with_carry, obs_cols=(0, 2), noise_idx=(0, 1),
    )
    y, c = tuple(jnp.asarray(v) for v in y0), ((jnp.zeros(BATCH),) if with_carry else ())
    ys, acts = [], []
    for t in range(T):
        y, c, a = step(y, c, t, (jnp.asarray(ref),), None, jnp.asarray(eo[t]), jnp.asarray(ep[t]))
        ys.append(y)
        acts.append(a[0])

    to_t = lambda v: torch.as_tensor(v)
    out = CL.fused_closed_loop(
        pe, tuple(to_t(v) for v in y0), policy, T, ref_leaves=(to_t(ref),), traj_stride=1,
        policy_carry=(torch.zeros(BATCH, dtype=torch.float64),) if with_carry else None,
        obs_noise_tm=to_t(eo), obs_noise_cols=(0, 2), proc_noise_tm=to_t(ep), proc_noise_idx=(0, 1),
    )
    final, traj_state, traj_act = (out[0], out[2], out[3]) if with_carry else out
    for i in range(2):
        _close(final[i], y[i])
        _close(traj_state[i], np.stack([s[i] for s in ys], axis=1))
    _close(traj_act[0], np.stack(acts, axis=1))
    if with_carry:
        _close(out[1][0], c[0])


def test_pi_matches_the_pallas_kernel_in_interpret_mode():
    """The TPU kernel itself (Pallas interpret mode, B = 1,024, T = 8, RK4)
    with a PI law and its carry, against the port's closed loop."""
    je, pe = _pair("Pendulum", "rk4", batch=1024)
    js, ps = _states(je, pe, 8)

    def pi(obs, t, c):
        integ = c[0] + 0.05 * (obs[2] - obs[0])
        return (-0.9 * obs[0] + -0.25 * obs[1] + 0.9 * obs[2] + integ,), (integ,)

    obs_j, acts_j, last_j, fc_j = jstepper.env_fused_closed_loop(je, js, pi, 8, obs_stride=1, interpret=True,
                                                                 policy_carry=(jnp.zeros(1024),))
    law = P.AffinePolicy([[-0.9, -0.25, 0.9]], Ki=[[-0.05, 0.0, 0.05]])
    obs_p, acts_p, last_p, fc_p = pe.fused_closed_loop(ps, law, 8, obs_stride=1,
                                                       policy_carry=(torch.zeros(1024, dtype=torch.float64),))
    _close(obs_p, obs_j)
    _close(acts_p, acts_j)
    _close(fc_p[0], fc_j[0])
    _close(last_p.physical_state.omega, last_j.physical_state.omega)


def test_plain_version_equals_the_step_loop_exactly():
    """Same operations in the same order: the plain closed loop IS a loop of
    vmap_step driven by the policy (tile_policy_scan)."""
    pe = P.Pendulum(batch_size=64, solver="rk4", control_state=["theta"], **F64)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(7))
    ps.reference.theta = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64)
    obs_s, acts_s, traj_s, last_s = tile_policy_scan(pe, ps, T, pd_pendulum, None, True)
    obs_f, acts_f, traj_f, last_f = pe.fused_closed_loop(ps, pd_pendulum, T, obs_stride=1,
                                                        return_traj_states=True)
    assert torch.equal(obs_s, obs_f) and torch.equal(acts_s, acts_f)
    assert torch.equal(traj_s.physical_state.omega, traj_f.physical_state.omega)
    assert torch.equal(last_s.physical_state.theta, last_f.physical_state.theta)


def test_out_of_scope_and_errors():
    pe = P.Pendulum(batch_size=8, control_state=["theta"], **F64)
    _, ps = pe.vmap_reset()
    ps.reference.theta = torch.zeros(8, dtype=torch.float64)
    # per-batch action normalization: out of the kernel's scope, no fallback
    wide = P.Pendulum(batch_size=8, control_state=["theta"],
                      action_normalizations={"torque": P.MinMaxNormalization(min=-20, max=np.full(8, 30.0))}, **F64)
    assert not CL.supports_fused_closed_loop(wide)
    assert closed_loop_path(wide) is None
    assert closed_loop_path(pe) == "closed_loop_fused"
    with pytest.raises(ValueError, match="scope"):
        wide.fused_closed_loop(ps, pd_pendulum, 4)
    with pytest.raises(ValueError, match="requires obs_stride"):
        pe.fused_closed_loop(ps, pd_pendulum, 4, return_traj_states=True)
    with pytest.raises(ValueError, match="divisible"):
        pe.fused_closed_loop(ps, pd_pendulum, 6, obs_stride=4)
    y0 = (ps.physical_state.theta, ps.physical_state.omega)
    kw = dict(tau=pe.tau, solver=pe._solver, props=pe.env_properties, ref_leaves=(ps.reference.theta,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        CL.kernel_closed_loop(pe, y0, P.AffinePolicy([[-0.9, -0.25, 0.9]]), 4, **kw)
    # a plain callable is refused by the kernel's wrapper before any launch
    CL.CL_KERNEL.reset_counts()
    with pytest.raises(ValueError, match="plain callable runs the loop on the CPU only"):
        CL.kernel_closed_loop(pe, y0, pd_pendulum, 4, **kw)
    assert CL.CL_KERNEL.launches == {"closed_loop": 0}



# ---------------------------------------------------------------------------
# the kernel's instantiations, chosen on the host
# ---------------------------------------------------------------------------


def _actor_weights(n_obs, hidden, seed=0):
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    rng = np.random.default_rng(seed)
    sizes = (n_obs, *hidden, 1)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    env = P.Pendulum(batch_size=4, control_state=["theta"], **F64)
    return actor_params_from_numpy(env, {"actor": layers, "log_std": np.full(1, -1.0), "seed": 7.0})


@pytest.mark.parametrize("n_state,gains,variant", [
    (2, [[-0.9, -0.25]], "affine"),                    # no reference: NOBS = N
    (2, [[-0.9, -0.25, 0.9]], "affine"),               # one reference: NOBS = N + 1 (the PD/PI main cases)
    (2, [[-0.9, -0.25, 0.9, 0.1]], "affine_generic"),  # two references
    (4, [[-0.5, -0.3, 0.8, 0.2, 0.5]], "affine"),      # CartPole tracking its deflection
    (4, [[-0.5, -0.3, 0.8, 0.2, 0.5, 0.1, 0.1]], "affine_generic"),
])
@pytest.mark.parametrize("integral", [False, True])
def test_affine_policy_picks_the_register_law_at_its_width(n_state, gains, variant, integral):
    """The affine law runs in registers at NOBS = N + n_refs for 0 or 1
    reference, whatever its integrator and clamp; other widths take the
    generic law of the same kernel."""
    policy = P.AffinePolicy(gains, Ki=gains if integral else None, clip=1.0 if integral else None)
    spec = policy.kernel_spec(torch.float32, "cpu")
    assert CL.kernel_variant(n_state, spec) == variant
    assert CL.VARIANTS.index(variant) in (0, 1)


@pytest.mark.parametrize("hidden,variant", [((16, 16), "actor_16x16"), ((24, 8), "actor_generic"),
                                            ((16,), "actor_generic"), ((16, 16, 16), "actor_generic")])
def test_actor_picks_the_register_mlp_for_two_hidden_layers_of_16(hidden, variant):
    actor, _ = P.make_actor_tile(P.Pendulum(batch_size=4, control_state=["theta"], **F64))
    spec = actor.kernel_spec(torch.float64, "cpu", _actor_weights(3, hidden))
    assert spec.options["widths"] == (3, *hidden, 1)
    assert CL.kernel_variant(2, spec) == variant


def test_variant_launch_counts_stay_at_zero_on_the_cpu():
    """CPU tensors take the plain version: no instantiation is launched."""
    je, pe = _pair("Pendulum")
    _, ps = _states(je, pe, 5)
    before = dict(CL.VARIANT_LAUNCHES)
    pe.fused_closed_loop(ps, P.AffinePolicy(PD["Pendulum"][1]), 4)
    assert CL.VARIANT_LAUNCHES == before and set(before) == set(CL.VARIANTS)
