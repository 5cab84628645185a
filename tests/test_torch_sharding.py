"""The batch split (``parallel/mesh.py::ShardedEnv``) against the port's
unsplit runs and the JAX package, on CPU tensors in float64.

The contracts of ``tests/test_sharding.py``: every split run equals the
port's unsplit run, and follows the JAX package's single-device run.

* Split against unsplit: ``torch.equal`` on every case that runs the same
  arithmetic per instance (steps, loops, the kernels' plain versions, the
  closed loops, the adaptive loop, the noise streams).  Each instance is
  computed on its own, and PyTorch's CPU kernels give each element the same
  result inside a 2-row shard as inside the 64-row batch (checked here on
  the trigonometry, the LUT gather and the Newton solve of every case).
  One kind of case is held to a stated tolerance instead: the gradient of
  policy parameters shared by the shards (per-shard gradients summed in
  another order than the batch sum, 1e-12 relative).
* Against JAX: rtol = atol = 1e-12 for the classic environments' rollouts
  and closed loops (XLA's CPU contracts multiply-adds, PyTorch does not);
  the PMSM drive at rtol 1e-11 and atol 1e-9 A, the PMSM files' tolerance,
  from the JAX package's state carried across (its keyed reset draws the
  current disc with other bits).

Meshes: ``["cpu"] * 8`` and ``["cpu"] * 2``.  ``make_batch_mesh()`` with no
devices raises on a machine without CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.parallel import (
    ShardedEnv,
    make_batch_mesh,
    mean_metric,
    shard_batched_tree,
    violation_fraction,
)
from exciting_environments_torch.parallel.mesh import _on_device
from exciting_environments_torch.utils.convert import state_from_numpy
from exciting_environments_tpu.core import structures as jstructures

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
PMSM_TOL = dict(rtol=1e-11, atol=1e-9)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
MESHES = [8, 2]


def _mesh(n):
    return make_batch_mesh(["cpu"] * n)


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _uniform(seed, shape, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape)


def _equal_trees(a, b):
    la, lb = structures.leaves(a), structures.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
                                         and torch.equal(x.nan_to_num(), y.nan_to_num())), (x, y)
        else:
            assert x == y or (x != x and y != y)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(t).double().numpy(), np.asarray(j, dtype=np.float64), **tol)


def _pmsm_pair(batch, seed=0, jax_kw=None, **kw):
    """The JAX and port PMSM drives and the JAX keyed reset carried across."""
    jkw = dict(kw, **(jax_kw or {}))
    je = J.PMSM(batch_size=batch, **jkw)
    pe = P.PMSM(batch_size=batch, **kw, **F64)
    jk, pk = _keys(seed, batch)
    _, js = je.vmap_reset(jk)
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS}, keys=pk)
    return je, pe, js, ps


# ---------------------------------------------------------------------------
# the mesh and placement
# ---------------------------------------------------------------------------


def test_make_batch_mesh_raises_without_cuda_and_the_batch_must_divide():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_batch_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedEnv(P.Pendulum(batch_size=8, **F64))
    mesh = _mesh(8)
    assert mesh.size == 8 and mesh.axis_names == ("batch",)
    with pytest.raises(ValueError, match="divisible"):
        ShardedEnv(P.Pendulum(batch_size=mesh.size * 4 + 1, **F64), mesh)


def test_shard_batched_tree_places_tensors_and_keeps_scalars():
    tree = (torch.ones(16, 3), 2.0, torch.ones(4))
    placed = shard_batched_tree(tree, 16, _mesh(8))
    assert placed[1] == 2.0 and placed[0].device.type == "cpu"
    assert torch.equal(placed[0], tree[0]) and torch.equal(placed[2], tree[2])


# ---------------------------------------------------------------------------
# the batched API, split over the shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", MESHES)
def test_split_step_and_rollout_equal_unsplit_and_jax(n):
    """vmap_reset/vmap_step (Pendulum) and vmap_rollout (MassSpringDamper,
    CartPole with obs_stride) split over the shards equal the unsplit calls
    bit for bit and follow the JAX package's."""
    B = 32
    jk, pk = _keys(0, B)
    je, pe = J.Pendulum(batch_size=B), P.Pendulum(batch_size=B, **F64)
    senv = ShardedEnv(pe, _mesh(n))
    o1, s1 = pe.vmap_reset(pk)
    o2, s2 = senv.vmap_reset(pk)
    _equal_trees((o1, s1), (o2, s2))
    a = _uniform(1, (B, 1), -1, 1)
    _equal_trees(pe.vmap_step(s1, torch.as_tensor(a)), senv.vmap_step(s2, torch.as_tensor(a)))
    obs_s, _ = senv.vmap_step(s2, torch.as_tensor(a))
    _, js = je.vmap_reset(jk)
    _close(obs_s, je.vmap_step(js, jnp.asarray(a))[0])

    for name, stride in (("MassSpringDamper", 1), ("CartPole", 5)):
        je, pe = getattr(J, name)(batch_size=B), getattr(P, name)(batch_size=B, **F64)
        senv = ShardedEnv(pe, _mesh(n))
        _, js = je.vmap_reset(jk)
        _, ps = pe.vmap_reset(pk)
        acts = _uniform(2, (B, 20, 1), -0.8, 0.8)
        split = senv.vmap_rollout(ps, torch.as_tensor(acts), stride)
        _equal_trees(pe.vmap_rollout(ps, torch.as_tensor(acts), stride), split)
        _close(split[0], je.vmap_rollout(js, jnp.asarray(acts), stride)[0])


@pytest.mark.parametrize("n", MESHES)
def test_heterogeneous_properties_ride_with_their_shard(n):
    """Per-batch ``(B,)`` properties are sliced to each shard's shadow, the
    wrapped environment keeps its whole tensors, and the split step equals
    the unsplit one."""
    B = 16
    lengths = np.linspace(1.0, 2.0, B)
    params = {"l": lengths, "g": 9.81, "m": 1}
    pe = P.Pendulum(batch_size=B, static_params=params, **F64)
    je = J.Pendulum(batch_size=B, static_params={"l": jnp.asarray(lengths), "g": 9.81, "m": 1})
    senv = ShardedEnv(pe, _mesh(n))
    b = B // n
    for i, shadow in enumerate(senv._local_shadows()):
        assert shadow.batch_size == b
        assert torch.equal(shadow.env_properties.static_params.l, pe.env_properties.static_params.l[i * b:(i + 1) * b])
        assert shadow.env_properties.static_params.g == 9.81
    assert tuple(pe.env_properties.static_params.l.shape) == (B,) and pe.batch_size == B
    _, ps = pe.vmap_reset()
    a = torch.full((B, 1), 0.5, dtype=torch.float64)
    split = senv.vmap_step(ps, a)
    _equal_trees(pe.vmap_step(ps, a), split)
    _close(split[0], je.vmap_step(je.vmap_reset()[1], jnp.asarray(a.numpy()))[0])


def test_metric_reduction_over_the_split_outputs():
    B = 64
    pe = P.Pendulum(batch_size=B, **F64)
    senv = ShardedEnv(pe, _mesh(8))
    _, s = senv.vmap_reset()
    obs, s = senv.vmap_step(s, torch.zeros(B, 1, dtype=torch.float64))
    assert mean_metric(obs).shape == ()
    frac = violation_fraction(pe.generate_truncated(s, pe.env_properties))
    assert 0.0 <= float(frac) <= 1.0
    # __getattr__ forwards to the whole-batch environment
    assert senv.batch_size == B and list(senv.obs_description) == list(pe.obs_description)


# ---------------------------------------------------------------------------
# the open-loop kernels, one launch per shard (plain versions on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("per_batch", [False, True])
def test_fused_rollout_per_shard_equals_unsplit_and_jax(n, per_batch):
    """The stepper kernel per shard (Pendulum, optionally with per-batch
    lengths): equal to the unsplit fused rollout, batch-major or
    time-major, with saves and traj states, and to the JAX scan."""
    B, T = 32, 12
    kw = {"static_params": {"g": 9.81, "l": 1.0 + np.linspace(0.0, 1.5, B), "m": 1.0}} if per_batch else {}
    jkw = {"static_params": {"g": 9.81, "l": jnp.asarray(1.0 + np.linspace(0.0, 1.5, B)), "m": 1.0}} if per_batch else {}
    je, pe = J.Pendulum(batch_size=B, **jkw), P.Pendulum(batch_size=B, **kw, **F64)
    senv = ShardedEnv(pe, _mesh(n))
    assert senv._fused_in_scope() and P.ops.kernels.rollout_path(senv) == "fused"
    jk, pk = _keys(0, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)
    acts = torch.as_tensor(_uniform(1, (B, T, 1), -0.9, 0.9))
    split = senv.fused_rollout(ps, acts, strict=True)
    _equal_trees(pe.fused_rollout(ps, acts, strict=True), split)
    tm = senv.fused_rollout(ps, acts.transpose(0, 1), time_major=True, strict=True)
    _equal_trees(split, tm)
    saves = senv.fused_rollout(ps, acts, obs_stride=3, return_traj_states=True)
    from exciting_environments_torch.ops.kernels.stepper import env_fused_rollout

    _equal_trees(env_fused_rollout(pe, ps, acts, obs_stride=3, return_traj_states=True), saves)
    obs_j, last_j = je.vmap_rollout(js, jnp.asarray(acts.numpy()), T)
    _close(split[0], obs_j[:, -1])
    _close(split[1].physical_state.omega, last_j.physical_state.omega)


@pytest.mark.parametrize("n", MESHES)
def test_fused_sim_ahead_per_shard_equals_unsplit_and_jax(n):
    """Tsit5 trajectory solves (CartPole with per-batch pole lengths, and a
    finer observation grid) per shard; the unequal-stepsize fallback."""
    B, T = 16, 6
    lp = 0.5 + np.linspace(0, 0.3, B)
    base = {"mu_p": 2e-6, "mu_c": 5e-4, "m_p": 0.1, "m_c": 1.0, "g": 9.81}
    je = J.CartPole(batch_size=B, solver="tsit5", static_params=dict(base, l=jnp.asarray(lp)))
    pe = P.CartPole(batch_size=B, solver="tsit5", static_params=dict(base, l=lp), **F64)
    senv = ShardedEnv(pe, _mesh(n))
    jk, pk = _keys(2, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)
    acts = torch.as_tensor(_uniform(3, (B, T, 1), -0.5, 0.5))
    for obs_step, stride in ((pe.tau, 1), (pe.tau / 2, 2)):
        split = senv.fused_sim_ahead(ps, acts, obs_step, pe.tau, obs_stride=stride, strict=True)
        _equal_trees(pe.fused_sim_ahead(ps, acts, obs_step, pe.tau, obs_stride=stride, strict=True), split)
        obs_j, _, _ = je.vmap_sim_ahead(js, jnp.asarray(acts.numpy()), obs_step, pe.tau)
        _close(split[0], np.asarray(obs_j)[:, ::stride])
    # a non-integral ratio takes the split vmap_sim_ahead; strict raises
    pd = P.Pendulum(batch_size=B, **F64)
    sd = ShardedEnv(pd, _mesh(n))
    _, s = pd.vmap_reset()
    a = torch.full((B, 4, 1), 0.2, dtype=torch.float64)
    obs, _ = sd.fused_sim_ahead(s, a, pd.tau / 2.5, pd.tau)
    assert torch.equal(obs, pd.vmap_sim_ahead(s, a, pd.tau / 2.5, pd.tau)[0])
    with pytest.raises(ValueError, match="strict"):
        sd.fused_sim_ahead(s, a, pd.tau / 2.5, pd.tau, strict=True)


def test_out_of_scope_falls_back_to_the_split_loop_and_strict_raises():
    B = 16
    pe = P.Pendulum(batch_size=B, solver="implicit_euler", **F64)
    senv = ShardedEnv(pe, _mesh(8))
    assert not senv._fused_in_scope() and P.ops.kernels.rollout_path(senv) == "scan"
    _, s = pe.vmap_reset()
    a = torch.full((B, 4, 1), 0.2, dtype=torch.float64)
    obs, last = senv.fused_rollout(s, a)
    assert obs.shape == (B, 2)
    assert torch.equal(obs, pe.vmap_rollout(s, a)[0][:, -1])
    obs_tm, _ = senv.fused_rollout(s, a.transpose(0, 1), time_major=True)
    assert torch.equal(obs_tm, obs)
    with pytest.raises(ValueError, match="strict"):
        senv.fused_rollout(s, a, strict=True)
    with pytest.raises(ValueError, match="return_traj_states"):
        senv.fused_rollout(s, a, obs_stride=1, return_traj_states=True)


@pytest.mark.parametrize("n", MESHES)
def test_pmsm_fused_rollout_per_shard_with_per_drive_r_s(n):
    """The PMSM kernel per shard on a saturated BRUSA fleet whose ``r_s``
    differs per drive: each shard launches with its own slice (a shard that
    read shard 0's slice would differ from the unsplit run), equal to the
    unsplit fused rollout and the JAX scan."""
    B, T = 16, 8
    r_s = 0.0183 * (1 + 0.3 * _uniform(5, (B,), 0, 1))
    params = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, r_s=r_s)
    jparams = dict(J.MotorVariant.BRUSA.get_params().static_params.__dict__, r_s=jnp.asarray(r_s))
    je, pe, js, ps = _pmsm_pair(B, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=params,
                                jax_kw=dict(motor_variant=J.MotorVariant.BRUSA, static_params=jparams))
    senv = ShardedEnv(pe, _mesh(n))
    assert P.ops.kernels.rollout_path(senv) == "pmsm_fused"
    acts = torch.as_tensor(_uniform(1, (B, T, 2), -0.4, 0.4))
    split = senv.fused_rollout(ps, acts, strict=True)
    _equal_trees(pe.fused_rollout(ps, acts, strict=True), split)
    obs_j, last_j = je.vmap_rollout(js, jnp.asarray(acts.numpy()), T)
    _close(split[0], obs_j[:, -1], PMSM_TOL)
    _close(split[1].physical_state.i_q, last_j.physical_state.i_q, PMSM_TOL)
    # the same per-drive slices through the launcher's env_properties override
    from exciting_environments_torch.ops.kernels.pmsm_stepper import pmsm_fused_rollout

    shadow = senv._local_shadow()
    one = pmsm_fused_rollout(shadow, senv._split(ps, 0), senv._split(acts, 0), strict=True,
                             env_properties=shadow.env_properties)
    _equal_trees(one[0], split[0][: B // n])
    wrong = pmsm_fused_rollout(shadow, senv._split(ps, 1), senv._split(acts, 1), strict=True)
    assert not torch.equal(wrong[0], split[0][B // n: 2 * B // n])


@pytest.mark.parametrize("n", MESHES)
def test_pmsm_sim_ahead_and_stochastic_rollout_per_shard(n):
    """The PMSM trajectory solve per shard, and a drive with current process
    and sensor noise: the draws hang off each instance's key, so the split
    run is draw for draw the unsplit one (final keys included)."""
    B, T = 16, 6
    je, pe, js, ps = _pmsm_pair(B, 1, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                                jax_kw=dict(motor_variant=J.MotorVariant.BRUSA))
    senv = ShardedEnv(pe, _mesh(n))
    acts = torch.as_tensor(_uniform(2, (B, T, 2), -0.4, 0.4))
    split = senv.fused_sim_ahead(ps, acts, pe.tau, pe.tau, strict=True)
    _equal_trees(pe.fused_sim_ahead(ps, acts, pe.tau, pe.tau, strict=True), split)
    _close(split[0], je.vmap_sim_ahead(js, jnp.asarray(acts.numpy()), pe.tau, pe.tau)[0], PMSM_TOL)

    noise = dict(process_noise={"i_d": 0.5, "i_q": 0.3}, observation_noise={"i_d": 0.02})
    pn = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, **noise, **F64)
    sn = ShardedEnv(pn, _mesh(n))
    sn_state = state_from_numpy(pn, {k: getattr(ps.physical_state, k).numpy() for k in PMSM_FIELDS},
                                keys=ps.PRNGKey)
    split = sn.fused_rollout(sn_state, acts, obs_stride=2, strict=True)
    _equal_trees(pn.fused_rollout(sn_state, acts, obs_stride=2, strict=True), split)
    assert torch.equal(split[1].PRNGKey, pn.vmap_rollout(sn_state, acts)[1].PRNGKey)


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_stochastic_rollouts_are_partition_invariant(noise_mode):
    """A noisy Pendulum in both draw modes: split loop and split kernel equal
    their unsplit runs, and the loop follows the JAX package's draws (keys
    bit for bit, normals within ``erfinv``'s last bits)."""
    B = 16
    kw = dict(tau=1e-2, process_noise={"omega": 0.4}, observation_noise={"theta": 0.02}, noise_mode=noise_mode)
    je, pe = J.Pendulum(batch_size=B, **kw), P.Pendulum(batch_size=B, **kw, **F64)
    senv = ShardedEnv(pe, _mesh(8))
    jk, pk = _keys(11, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)
    acts = torch.as_tensor(_uniform(4, (B, 16, 1), -0.9, 0.9))
    split = senv.vmap_rollout(ps, acts)
    _equal_trees(pe.vmap_rollout(ps, acts), split)
    _equal_trees(pe.fused_rollout(ps, acts, obs_stride=4), senv.fused_rollout(ps, acts, obs_stride=4))
    obs_j, last_j = je.vmap_rollout(js, jnp.asarray(acts.numpy()))
    np.testing.assert_allclose(split[0].numpy(), np.asarray(obs_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(split[1].PRNGKey.numpy(), np.asarray(last_j.PRNGKey).astype(np.int64))


def test_per_batch_physical_norms_ride_the_split_kernel():
    """Per-batch normalization spans, with sensor noise scaled through them,
    stay in kernel scope per shard and match the unsplit run draw for draw."""
    B = 16
    pe = P.Pendulum(batch_size=B, tau=1e-2, observation_noise={"theta": 0.05}, **F64,
                    physical_normalizations={"theta": P.MinMaxNormalization(-np.pi, np.pi),
                                             "omega": P.MinMaxNormalization(-np.full(B, 10.0), np.full(B, 10.0))})
    senv = ShardedEnv(pe, _mesh(8))
    assert senv._fused_in_scope()
    _, s = pe.vmap_reset(R.split(R.PRNGKey(0, "cpu"), B))
    a = torch.zeros(B, 8, 1, dtype=torch.float64)
    _equal_trees(pe.fused_rollout(s, a, strict=True), senv.fused_rollout(s, a, strict=True))


# ---------------------------------------------------------------------------
# shadows
# ---------------------------------------------------------------------------


def test_shadows_drop_device_caches_and_move_their_tensors():
    """A shadow never reads the parent's full-batch or device-bound caches:
    the noise-coefficient cache is dropped, and a shadow on another device
    (``meta`` here) holds its properties and its magnetics table there."""
    B = 16
    pe = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                process_noise={"i_d": 0.5}, **F64)
    pe._noise_coef(pe.tau)
    assert "_noise_coefs" in pe.__dict__
    senv = ShardedEnv(pe, _mesh(2))
    assert all("_noise_coefs" not in s.__dict__ for s in senv._local_shadows())
    assert "_noise_coefs" in pe.__dict__ and pe.batch_size == B
    meta = _on_device(pe, "meta")
    assert meta.device.type == "meta" and meta._lut.values.device.type == "meta"
    assert meta._lut is not pe._lut and pe._lut.values.device.type == "cpu"
    tensors = [x for x in structures.leaves(meta.env_properties) if isinstance(x, torch.Tensor)]
    assert all(t.device.type == "meta" for t in tensors)


def test_adaptive_rollout_per_shard_with_per_batch_props():
    """Each shard's step-size loop runs on its own with its property slice;
    counts and states equal the unsplit run, and follow JAX's."""
    from exciting_environments_torch.ops.adaptive import adaptive_rollout
    from exciting_environments_tpu.ops.adaptive import adaptive_rollout as j_adaptive

    B = 16
    lengths = np.linspace(1.0, 2.0, B)
    pe = P.Pendulum(batch_size=B, static_params={"l": lengths, "g": 9.81, "m": 1}, **F64)
    je = J.Pendulum(batch_size=B, static_params={"l": jnp.asarray(lengths), "g": 9.81, "m": 1})
    senv = ShardedEnv(pe, _mesh(8))
    jk, pk = _keys(3, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)
    acts = torch.as_tensor(_uniform(4, (B, 6, 1), -0.5, 0.5))
    split = senv.adaptive_rollout(ps, acts, rtol=1e-7, atol=1e-9)
    _equal_trees(adaptive_rollout(pe, ps, acts, rtol=1e-7, atol=1e-9), split)
    obs_j, _, stats_j = j_adaptive(je, js, jnp.asarray(acts.numpy()), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(split[0].numpy(), np.asarray(obs_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(split[2].accepted.numpy(), np.asarray(stats_j.accepted))
    assert float(torch.std(split[1].physical_state.theta)) > 1e-3


# ---------------------------------------------------------------------------
# closed loops, one launch per shard
# ---------------------------------------------------------------------------


def _pd(obs, t):
    return (-0.8 * (obs[0] - obs[2]) - 0.3 * obs[1],)


def _pi(obs, t, carry):
    e = obs[2] - obs[0]
    integ = carry[0] + 0.05 * e
    return (0.8 * e + integ - 0.3 * obs[1],), (integ,)


def _tracking_pendulums(B, seed=0, **kw):
    je = J.Pendulum(batch_size=B, control_state=["theta"], **kw)
    pe = P.Pendulum(batch_size=B, control_state=["theta"], **kw, **F64)
    jk, pk = _keys(seed, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)
    ref = np.linspace(-1, 1, B)
    js = jstructures.replace(js, reference=jstructures.replace(js.reference, theta=jnp.asarray(ref)))
    ps = structures.replace(ps, reference=structures.replace(ps.reference, theta=torch.as_tensor(ref)))
    return je, pe, js, ps


@pytest.mark.parametrize("n", MESHES)
def test_fused_closed_loop_per_shard_equals_unsplit_and_jax(n):
    """The PD law and a stateful PI law (its ``(B,)`` carry split with the
    batch) per shard: equal to the unsplit closed loop, carry included, and
    to the JAX package's ``tile_policy_scan``."""
    from exciting_environments_tpu.utils.collect import tile_policy_scan

    B, T = 16, 8
    je, pe, js, ps = _tracking_pendulums(B, 2)
    senv = ShardedEnv(pe, _mesh(n))
    assert senv.closed_loop_in_scope()
    split = senv.fused_closed_loop(ps, _pd, T, obs_stride=1)
    _equal_trees(pe.fused_closed_loop(ps, _pd, T, obs_stride=1), split)
    obs_j = tile_policy_scan(je, js, T, _pd, None, collect_trajectory=True)[0]
    _close(split[0], obs_j)

    carry0 = (torch.as_tensor(0.01 * np.linspace(-1.0, 1.0, B)),)
    split = senv.fused_closed_loop(ps, _pi, T, obs_stride=1, policy_carry=carry0, return_traj_states=True)
    _equal_trees(pe.fused_closed_loop(ps, _pi, T, obs_stride=1, policy_carry=carry0, return_traj_states=True),
                 split)
    out_j = tile_policy_scan(je, js, T, _pi, None, collect_trajectory=True,
                             policy_carry=(jnp.asarray(carry0[0].numpy()),))
    _close(split[0], out_j[0])
    _close(split[-1][0], out_j[-1][0])


def test_stochastic_pi_closed_loop_per_shard():
    """Output feedback under sensor and process noise with a stateful PI law:
    each shard's noise slab comes from its own keys, so the split loop
    equals the unsplit one draw for draw, and follows the JAX package's
    ``tile_policy_scan``."""
    from exciting_environments_tpu.utils.collect import tile_policy_scan

    B, T = 16, 8
    kw = dict(tau=1e-2, process_noise={"omega": 0.3}, observation_noise={"theta": 0.04})
    je, pe = J.Pendulum(batch_size=B, **kw), P.Pendulum(batch_size=B, **kw, **F64)
    jk, pk = _keys(5, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)

    def pol(obs, t, c):
        i = c[0] + 0.05 * obs[0]
        return (-0.8 * obs[0] - 0.1 * i,), (i,)

    senv = ShardedEnv(pe, _mesh(8))
    carry0 = (torch.zeros(B, dtype=torch.float64),)
    split = senv.fused_closed_loop(ps, pol, T, obs_stride=1, policy_carry=carry0)
    _equal_trees(pe.fused_closed_loop(ps, pol, T, obs_stride=1, policy_carry=carry0), split)
    out_j = tile_policy_scan(je, js, T, pol, None, collect_trajectory=True, policy_carry=(jnp.zeros(B),))
    np.testing.assert_allclose(split[0].numpy(), np.asarray(out_j[0]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(split[1].numpy(), np.asarray(out_j[1]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(split[-1][0].numpy(), np.asarray(out_j[-1][0]), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(split[2].PRNGKey.numpy(), np.asarray(out_j[3].PRNGKey).astype(np.int64))


@pytest.mark.parametrize("n", MESHES)
def test_pmsm_closed_loop_per_shard_with_per_drive_u_dc(n):
    """A fleet with per-drive ``u_dc`` and ``r_s`` closes its loops in the
    PMSM closed-loop kernel per shard, each shard with its slices, equal to
    the unsplit kernel (a stateful tile's carry too)."""
    from exciting_environments_torch.utils import randomize as PR

    B, T = 16, 8
    var = P.MotorVariant.BRUSA
    fleet = PR.randomize_env(P.PMSM, R.PRNGKey(3, "cpu"),
                             {"u_dc": PR.Uniform(350.0, 450.0), "r_s": PR.Uniform(15e-3, 21e-3)},
                             batch_size=B, defaults=dict(var.get_params().static_params.__dict__),
                             saturated=True, motor_variant=var, **F64)
    senv = ShardedEnv(fleet, _mesh(n))
    assert senv.closed_loop_in_scope()
    _, st = fleet.vmap_reset(R.split(R.PRNGKey(1, "cpu"), B))

    def policy(obs, t):
        return (0.8 + 0.1 * obs[0], 0.7 + 0.1 * obs[1])

    _equal_trees(fleet.fused_closed_loop(st, policy, T), senv.fused_closed_loop(st, policy, T))

    def tile(obs, t, c):
        (ci,) = c
        return (0.5 + 0.0 * obs[0], torch.clamp(0.1 * ci, -1, 1)), (ci + 0.1,)

    c0 = (torch.zeros(B, dtype=torch.float64),)
    _equal_trees(fleet.fused_closed_loop(st, tile, T, policy_carry=c0),
                 senv.fused_closed_loop(st, tile, T, policy_carry=c0))


def test_closed_loop_policy_gradient_sums_over_the_shards():
    """Gradients of shared policy parameters through the split closed loop:
    the per-shard gradients sum to the unsplit loop's (1e-12 relative, the
    sums run in another order), and follow ``jax.grad`` of the JAX scan."""
    B, T = 32, 4
    je, pe, js, ps = _tracking_pendulums(B, 0)
    senv = ShardedEnv(pe, _mesh(2))

    def pol(o, t, p):
        return (-p["kp"] * (o[0] - o[2]) - p["kd"] * o[1],)

    def loss(env):
        p = {"kp": torch.tensor(0.5, dtype=torch.float64, requires_grad=True),
             "kd": torch.tensor(0.1, dtype=torch.float64, requires_grad=True)}
        obs = env.fused_closed_loop(ps, pol, T, obs_stride=1, policy_params=p)[0]
        value = torch.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2)
        value.backward()
        return value.detach(), p["kp"].grad, p["kd"].grad

    vs, vp = loss(senv), loss(pe)
    assert torch.equal(vs[0], vp[0])
    for a, b in zip(vs[1:], vp[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12)

    from exciting_environments_tpu.utils.collect import tile_policy_scan

    def jloss(p):
        obs = tile_policy_scan(je, js, T, pol, p, collect_trajectory=True)[0]
        return jnp.mean((obs[:, :, 0] - obs[:, :, 2]) ** 2)

    gj = jax.grad(jloss)({"kp": jnp.asarray(0.5), "kd": jnp.asarray(0.1)})
    np.testing.assert_allclose(float(vs[1]), float(gj["kp"]), rtol=1e-10)
    np.testing.assert_allclose(float(vs[2]), float(gj["kd"]), rtol=1e-10)


def test_collectors_and_training_through_the_split():
    """``collect_fused`` and ``collect_policy_fused`` on a ``ShardedEnv`` run
    one launch per shard and equal their unsplit batches; ``train_policy``
    on a ``ShardedEnv`` equals the unsplit training (losses at 1e-12, the
    shared parameters' gradients summed over the shards)."""
    from exciting_environments_torch.utils.collect import RolloutCollector
    from exciting_environments_torch.utils.train import train_policy

    B, T = 16, 6
    _, pe, _, ps = _tracking_pendulums(B, 4)
    senv = ShardedEnv(pe, _mesh(8))
    acts = torch.as_tensor(_uniform(6, (B, T, 1), -0.9, 0.9))
    _equal_trees(RolloutCollector(pe).collect_fused(ps, acts), RolloutCollector(senv).collect_fused(ps, acts))
    _equal_trees(RolloutCollector(pe).collect_policy_fused(_pd, ps, T),
                 RolloutCollector(senv).collect_policy_fused(_pd, ps, T))

    def pol(o, t, p):
        return (-p[0] * (o[0] - o[2]) - p[1] * o[1],)

    params = torch.tensor([0.5, 0.1], dtype=torch.float64)
    r_split = train_policy(senv, pol, params, ps, T, 3)
    r_whole = train_policy(pe, pol, params, ps, T, 3)
    np.testing.assert_allclose(r_split.losses.numpy(), r_whole.losses.numpy(), rtol=1e-12)
    np.testing.assert_allclose(r_split.params.numpy(), r_whole.params.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# planning and learning on a ShardedEnv
# ---------------------------------------------------------------------------


def _planning_pair(B, seed):
    from exciting_environments_torch.utils.episodes import reset_with_references

    pe = P.Pendulum(batch_size=B, tau=2e-2, control_state=["theta"], **F64)
    _, state = reset_with_references(pe, R.PRNGKey(seed, "cpu"))
    return pe, state


def test_mppi_on_the_scan_backend_equals_unsplit():
    """On the scan backend a ``ShardedEnv`` plans as its whole batch: the
    plan and the receding-horizon run equal the unsplit ones."""
    from exciting_environments_torch.utils import mpc

    B = 16
    cfg = mpc.MPPIConfig(horizon=6, n_samples=16, noise_sigma=0.4, n_iterations=2)
    pe, state = _planning_pair(B, 0)
    senv = ShardedEnv(pe, _mesh(8))
    plan0 = torch.zeros(B, 6, 1, dtype=torch.float64)
    k = R.PRNGKey(1, "cpu")
    assert torch.equal(mpc.mppi_plan(senv, state, plan0, k, cfg, fused=False),
                       mpc.mppi_plan(pe, state, plan0, k, cfg, fused=False))
    _equal_trees(mpc.run_mppi(senv, state, 3, key=R.PRNGKey(2, "cpu"), config=cfg, fused=False),
                 mpc.run_mppi(pe, state, 3, key=R.PRNGKey(2, "cpu"), config=cfg, fused=False))


def test_fused_mppi_runs_per_shard_with_folded_keys():
    """The fused backend plans shard by shard: each shard's plan equals
    ``_plan_core`` on its rows with the key folded with its index (the
    decorrelated draws of the JAX package's per-shard body)."""
    from exciting_environments_torch.parallel.mesh import _concat
    from exciting_environments_torch.utils import mpc

    B = 16
    cfg = mpc.MPPIConfig(horizon=4, n_samples=32, noise_sigma=0.4, n_iterations=1)
    pe, state = _planning_pair(B, 0)
    senv = ShardedEnv(pe, _mesh(8))
    assert mpc.planning_path(senv, cfg) == "fused"
    plan0 = torch.zeros(B, 4, 1, dtype=torch.float64)
    key = R.PRNGKey(1, "cpu")
    plan_s = mpc.mppi_plan(senv, state, plan0, key, cfg, fused=True)
    for i in (0, 3, 7):
        sl = slice(2 * i, 2 * i + 2)
        expected = mpc._plan_core(senv._local_shadows()[i], senv._split(state, i), plan0[sl],
                                  R.fold_in(key, i), cfg, None, True)
        assert torch.equal(plan_s[sl], expected)
    res = mpc.run_mppi(senv, state, 3, key=R.PRNGKey(2, "cpu"), config=cfg, fused=True)
    assert res.observations.shape == (B, 3, 3) and bool(torch.isfinite(res.observations).all())
    assert bool((res.rewards <= 0).all())
    parts = [mpc._control_core(s, senv._split(state, i), plan0[2 * i:2 * i + 2], R.fold_in(R.PRNGKey(2, "cpu"), i),
                               cfg, None, True, 3) for i, s in enumerate(senv._local_shadows())]
    _equal_trees(tuple(res), _concat(parts, torch.device("cpu")))


def test_fused_mppi_refuses_per_batch_params():
    from exciting_environments_torch.utils import mpc
    from exciting_environments_torch.utils.episodes import reset_with_references

    B = 16
    pe = P.Pendulum(batch_size=B, tau=2e-2, control_state=["theta"],
                    static_params={"l": np.linspace(0.5, 2.0, B), "g": 9.81, "m": 1.0}, **F64)
    senv = ShardedEnv(pe, _mesh(8))
    cfg = mpc.MPPIConfig(horizon=4, n_samples=8)
    assert mpc.planning_path(senv, cfg) == "scan"
    _, state = reset_with_references(pe, R.PRNGKey(0, "cpu"))
    with pytest.raises(ValueError, match="fused=True"):
        mpc.mppi_plan(senv, state, torch.zeros(B, 4, 1, dtype=torch.float64), R.PRNGKey(1, "cpu"), cfg,
                      fused=True)


def test_gradient_planner_ilqr_and_ppo_run_as_the_whole_batch():
    """``optimize_actions``, ``ilqr_plan`` and ``train_ppo`` /
    ``evaluate_policy`` on a ``ShardedEnv`` equal their unsplit runs (they
    unwrap the facade, ``episodes.unwrap_sharded``)."""
    from exciting_environments_torch.utils import ilqr, mpc
    from exciting_environments_torch.utils.episodes import unwrap_sharded
    from exciting_environments_torch.utils.rl import PPOConfig, evaluate_policy, train_ppo

    B = 16
    pe, state = _planning_pair(B, 5)
    senv = ShardedEnv(pe, _mesh(8))
    core, place = unwrap_sharded(senv)
    assert core is senv.env and place is not None
    plan0 = torch.zeros(B, 8, 1, dtype=torch.float64)
    _equal_trees(mpc.optimize_actions(senv, state, plan0, iterations=5, learning_rate=0.2),
                 mpc.optimize_actions(pe, state, plan0, iterations=5, learning_rate=0.2))
    _equal_trees(ilqr.ilqr_plan(senv, state, plan0, iterations=2), ilqr.ilqr_plan(pe, state, plan0, iterations=2))
    cfg = PPOConfig(n_steps=8, n_epochs=2, n_minibatches=4, max_episode_steps=16)
    rs = train_ppo(senv, iterations=2, key=R.PRNGKey(0, "cpu"), config=cfg)
    rw = train_ppo(pe, iterations=2, key=R.PRNGKey(0, "cpu"), config=cfg)
    for name in rw.metrics:
        assert torch.equal(torch.as_tensor(rs.metrics[name]), torch.as_tensor(rw.metrics[name])), name
    assert evaluate_policy(senv, rs.params, 8, max_episode_steps=16) == evaluate_policy(
        pe, rw.params, 8, max_episode_steps=16)


def test_fleet_filtering_per_shard_equals_the_whole_fleet():
    """The EKF over a fleet is per-instance: filtering each shard's plants on
    its shadow and joining the beliefs equals filtering the whole fleet."""
    from exciting_environments_torch.parallel.mesh import _concat
    from exciting_environments_torch.utils import estimate

    B, T = 16, 12
    pe = P.Pendulum(batch_size=B, tau=2e-2, observation_noise={"theta": 0.08}, **F64)
    _, st = pe.vmap_reset(R.split(R.PRNGKey(7, "cpu"), B))
    t = torch.arange(T, dtype=torch.float64) * 2e-2
    acts = (0.3 * torch.sin(2.0 * t))[None, :, None].expand(B, T, 1).contiguous()
    obs, _ = pe.vmap_rollout(st, acts)
    kw = dict(measured_fields=("theta",), process_std={"omega": 0.05})
    whole = estimate.run_ekf(pe, obs, acts, **kw)
    senv = ShardedEnv(pe, _mesh(8))
    parts = [estimate.run_ekf(s, senv._split(obs, i), senv._split(acts, i), **kw)
             for i, s in enumerate(senv._local_shadows())]
    joined = _concat(parts, torch.device("cpu"))
    assert torch.equal(joined.means, whole.means) and torch.equal(joined.nll, whole.nll)


def test_env_properties_override_replaces_the_properties_for_one_launch():
    """Each env-level launcher's ``env_properties=`` makes the launch read
    the given properties instead of the environment's: the result equals
    the launch on an environment built with them; leaves of another batch
    size raise."""
    from exciting_environments_torch.ops.kernels.pmsm_closed_loop import pmsm_fused_closed_loop
    from exciting_environments_torch.ops.kernels.pmsm_stepper import pmsm_fused_rollout, pmsm_fused_sim_ahead
    from exciting_environments_torch.ops.kernels.stepper import env_fused_rollout, env_fused_sim_ahead

    B, T = 8, 5
    mk = lambda scale: P.Pendulum(batch_size=B, static_params={"g": 9.81, "l": scale * (1 + np.arange(B) / B),
                                                               "m": 1.0}, **F64)
    pa, pb = mk(1.0), mk(1.7)
    _, s = pa.vmap_reset(R.split(R.PRNGKey(0, "cpu"), B))
    a = torch.as_tensor(_uniform(0, (B, T, 1), -0.9, 0.9))
    _equal_trees(env_fused_rollout(pa, s, a, obs_stride=1, env_properties=pb.env_properties),
                 env_fused_rollout(pb, s, a, obs_stride=1))
    _equal_trees(env_fused_sim_ahead(pa, s, a, pa.tau, pa.tau, env_properties=pb.env_properties),
                 env_fused_sim_ahead(pb, s, a, pb.tau, pb.tau))
    assert not torch.equal(env_fused_rollout(pa, s, a)[0], env_fused_rollout(pb, s, a)[0])

    var = P.MotorVariant.BRUSA
    base = dict(var.get_params().static_params.__dict__)
    da, db = (P.PMSM(batch_size=B, saturated=True, motor_variant=var, **F64,
                     static_params=dict(base, r_s=r * np.ones(B), u_dc=u * np.ones(B)))
              for r, u in ((0.015, 350.0), (0.021, 450.0)))
    _, ds = da.vmap_reset(R.split(R.PRNGKey(1, "cpu"), B))
    v = torch.as_tensor(_uniform(1, (B, T, 2), -0.5, 0.5))
    _equal_trees(pmsm_fused_rollout(da, ds, v, env_properties=db.env_properties), pmsm_fused_rollout(db, ds, v))
    _equal_trees(pmsm_fused_sim_ahead(da, ds, v, da.tau, da.tau, env_properties=db.env_properties),
                 pmsm_fused_sim_ahead(db, ds, v, db.tau, db.tau))

    def policy(obs, t):
        return (0.8 + 0.1 * obs[0], 0.7 + 0.1 * obs[1])

    _equal_trees(pmsm_fused_closed_loop(da, ds, policy, T, env_properties=db.env_properties),
                 pmsm_fused_closed_loop(db, ds, policy, T))
    wrong = mk(1.0)
    wrong.env_properties.static_params.l = torch.ones(B + 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="batch_size"):
        env_fused_rollout(pa, s, a, env_properties=wrong.env_properties)
