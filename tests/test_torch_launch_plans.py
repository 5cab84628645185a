"""Launch plans of the closed-loop wrappers (``ops/kernels/plans.py``), on
the CPU: the key of what a launch's checks and static fields read, the
plans it finds and misses, the policies' kept specs that tell a plan
whether its spec is still the policy's, and the cache's bound.  A plan's
launch against the full path's, bit for bit, runs on the card
(``tests/test_torch_gpu.py``)."""

import ctypes
import gc
import weakref

import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.ops.kernels.plans import _PLANS_KEPT, Key, PlanCache, Pointers, fits
from exciting_environments_torch.utils import MinMaxNormalization
from exciting_environments_torch.utils import foc
from exciting_environments_torch.utils.rl_fused import ActorPolicy

B = 8
PI_K = [[-0.6] + [0.0] * 7 + [0.6, 0.0], [0.0, -0.6] + [0.0] * 7 + [0.6]]
PI_KI = [[-0.01] + [0.0] * 7 + [0.01, 0.0], [0.0, -0.01] + [0.0] * 7 + [0.01]]
CPU = torch.device("cpu")


def _drive(per_batch=False):
    params = None
    if per_batch:
        params = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=1,
                      u_dc=torch.linspace(350.0, 450.0, B), r_s=torch.linspace(0.015, 0.021, B))
    return P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                  static_params=params, device="cpu")


def _machine(per_drive_torque=True):
    env = P.InductionMachine(batch_size=B, u_dc=560.0, device="cpu", dtype=torch.float64)
    torque = torch.linspace(-4.0, 4.0, B, dtype=torch.float64) if per_drive_torque else 2.0
    tile, _ = foc.make_foc_tile(env, psi_ref=0.4, torque_ref=torque)
    return env, tile


def _pmsm_key(env, policy, **over):
    kw = dict(props=env.env_properties, solver=env._solver, policy_params=None, sched_lut=None, tau=env.tau,
              n_steps=64, traj_stride=None, dtype=torch.float32, device=CPU, batch=B, n_refs=2, n_carry=2,
              obs_noise_cols=(), proc_noise_idx=(), has_obs_noise=False, has_proc_noise=False)
    kw.update(over)
    return PCL._plan_key(env, kw.pop("props"), kw.pop("solver"), policy, **kw)


def _cl_key(env, policy, **over):
    kw = dict(props=env.env_properties, solver=env._solver, policy_params=None, tau=env.tau, n_steps=64,
              traj_stride=None, dtype=torch.float64, device=CPU, batch=B, n_state=4, n_refs=0, n_carry=4,
              obs_noise_cols=(), proc_noise_idx=(), has_obs_noise=False, has_proc_noise=False)
    kw.update(over)
    return CL._plan_key(env, kw.pop("props"), kw.pop("solver"), policy, **kw)


def _cache():
    return PlanCache({"hits": 0, "misses": 0})


def test_the_same_inputs_find_the_kept_plan():
    """Keys built twice from the same inputs name the same plan, in either
    wrapper, and a policy that packed nothing since still hands out the
    plan's spec."""
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    im, tile = _machine()
    for key_of, e, policy, dtype in ((_pmsm_key, env, pi, torch.float32), (_cl_key, im, tile, torch.float64)):
        spec = policy.kernel_spec(dtype, CPU)
        cache = _cache()
        assert cache.keep(key_of(e, policy), "args", policy, extra="detail")
        plan = cache.find(key_of(e, policy))
        assert plan is not None and plan.args == "args" and plan.extra == "detail"
        assert policy.kernel_spec(dtype, CPU) is spec and plan.current(policy)
        assert len(cache) == 1


def _set(obj, name, value):
    setattr(obj, name, value)


PMSM_CHANGES = {
    "a band tensor written in place": lambda c: c["env"].env_properties.static_params.u_dc.add_(1.0),
    "a parameter tensor written in place": lambda c: c["env"].env_properties.static_params.r_s.mul_(1.01),
    "a parameter replaced": lambda c: _set(c["env"].env_properties.static_params, "r_s", 0.02),
    "a normalization replaced": lambda c: _set(c["env"].env_properties.physical_normalizations, "i_d",
                                               MinMaxNormalization(min=-300.0, max=0.0)),
    "a new policy_params tensor": lambda c: c["over"].update(policy_params=c["params"].clone()),
    "an in-place step on policy_params": lambda c: c["params"].add_(0.1),
    "another dtype": lambda c: c["over"].update(dtype=torch.float64),
    "another batch": lambda c: c["over"].update(batch=B + 1),
    "another n_steps": lambda c: c["over"].update(n_steps=128),
    "saves": lambda c: c["over"].update(traj_stride=16),
    "sensor noise": lambda c: c["over"].update(obs_noise_cols=(0, 1), has_obs_noise=True),
    "another solver": lambda c: c["over"].update(solver=P.PMSM(batch_size=B, solver="rk4", device="cpu")._solver),
    "another policy": lambda c: c.update(policy=P.AffinePolicy(PI_K, Ki=PI_KI)),
}


@pytest.mark.parametrize("change", list(PMSM_CHANGES))
def test_a_changed_static_input_misses(change):
    """Each input a launch's checks or static fields read, changed (written
    in place, replaced, or another value), makes the kept plan's key miss."""
    params = torch.cat([torch.tensor(PI_K).reshape(-1), torch.zeros(2), torch.tensor(PI_KI).reshape(-1)])
    ctx = {"env": _drive(per_batch=True), "policy": P.AffinePolicy(PI_K, Ki=PI_KI), "params": params, "over": {}}
    cache = _cache()
    assert cache.keep(_pmsm_key(ctx["env"], ctx["policy"], policy_params=params), "args", ctx["policy"])
    assert cache.find(_pmsm_key(ctx["env"], ctx["policy"], policy_params=params)) is not None
    PMSM_CHANGES[change](ctx)
    over = {"policy_params": params, **ctx["over"]}
    assert cache.find(_pmsm_key(ctx["env"], ctx["policy"], **over)) is None


def test_a_classic_environment_changed_misses():
    """The classic wrapper's key: another machine, a parameter, a
    normalization, the fast-math flag or a noise slab each miss."""
    im, tile = _machine()
    cache = _cache()
    assert cache.keep(_cl_key(im, tile), "args", tile)
    assert cache.find(_cl_key(im, tile)) is not None
    other, _ = _machine()
    assert cache.find(_cl_key(other, tile)) is None
    assert cache.find(_cl_key(im, tile, has_proc_noise=True, proc_noise_idx=(0,))) is None
    im.fast_math = True
    assert cache.find(_cl_key(im, tile)) is None
    im.fast_math = False
    assert cache.find(_cl_key(im, tile)) is not None
    im.env_properties.static_params.r_s = 3.0
    assert cache.find(_cl_key(im, tile)) is None
    cache.keep(_cl_key(im, tile), "args", tile)
    im.env_properties.action_normalizations.u_sd = MinMaxNormalization(min=-300.0, max=300.0)
    assert cache.find(_cl_key(im, tile)) is None


def _pmsm_tile():
    env = P.PMSM(batch_size=B, motor_variant=P.MotorVariant.DEFAULT, control_state=[], device="cpu",
                 static_params=dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__, deadtime=1))
    tile, _ = foc.make_pmsm_sensorless_current_tile(env, i_d_ref=-30.0, i_q_ref=60.0, omega_el=1200.0,
                                                    measurement_std={"i_d": 3.0, "i_q": 3.0})
    return tile


POLICY_CHANGES = {
    "AffinePolicy gains written in place": (lambda: P.AffinePolicy(PI_K, Ki=PI_KI), lambda p: p.K.mul_(2.0)),
    "AffinePolicy gains replaced": (lambda: P.AffinePolicy(PI_K), lambda p: _set(p, "K", p.K * 2.0)),
    "AffinePolicy clip set": (lambda: P.AffinePolicy(PI_K), lambda p: _set(p, "clip", 0.5)),
    "tile slot set (the law's gain)": (lambda: _machine()[1], lambda t: _set(t.law, "kp", 55.0)),
    "tile slot set (a constant item)": (_pmsm_tile, lambda t: t.consts.__setitem__("i_d_ref", -20.0)),
    "tile option set": (_pmsm_tile, lambda t: _set(t, "delayed", False)),
    "tile plane written in place": (lambda: _machine()[1], lambda t: t.law.torque_ref.mul_(-0.5)),
    "tile plane replaced": (lambda: _machine()[1], lambda t: _set(t.law, "torque_ref", t.law.torque_ref * 2.0)),
    "machine parameter the tile folds, set on the shared parameters": (
        lambda: _machine(per_drive_torque=False)[1], lambda t: _set(t.law.params, "l_m", 0.2)),
}


@pytest.mark.parametrize("change", list(POLICY_CHANGES))
def test_a_changed_policy_packs_a_new_spec_and_leaves_the_plan_stale(change):
    """A policy keeps its spec and hands it out again while nothing it reads
    changed, without reading its slot values again (one pack); a change
    packs a new spec, counted in ``spec_packs``, so that a kept plan is no
    longer current."""
    make, mutate = POLICY_CHANGES[change]
    policy = make()
    dtype = torch.float32
    spec = policy.kernel_spec(dtype, CPU)
    packs = policy.spec_packs
    if isinstance(policy, foc._SlotTile):
        reads = []
        slot_values = policy._slot_values
        policy._slot_values = lambda: reads.append(1) or slot_values()
        policy.kernel_spec(dtype, CPU)  # the set above counts as a change once
        spec, packs = policy.kernel_spec(dtype, CPU), policy.spec_packs
        reads.clear()
    plan = _cache()
    assert plan.keep(Key(), "args", policy)
    kept = plan.find(Key())
    assert [policy.kernel_spec(dtype, CPU) is spec for _ in range(3)] == [True] * 3 and kept.current(policy)
    if isinstance(policy, foc._SlotTile):
        assert reads == []
    mutate(policy)
    new = policy.kernel_spec(dtype, CPU)
    assert new is not spec and policy.spec_packs == packs + 1 and not kept.current(policy)
    assert not torch.equal(new.flat, spec.flat) or new.options != spec.options or any(
        not torch.equal(a, b) for a, b in zip(new.planes, spec.planes))
    assert policy.kernel_spec(dtype, CPU) is new


def test_affine_policy_keeps_one_spec_per_type_and_device_and_packs_recorded_gains_every_launch():
    pi = P.AffinePolicy(PI_K, Ki=PI_KI)
    f32, f64 = pi.kernel_spec(torch.float32, CPU), pi.kernel_spec(torch.float64, CPU)
    assert pi.kernel_spec(torch.float32, "cpu") is f32 and pi.kernel_spec(torch.float64, CPU) is f64
    assert f32.flat.dtype == torch.float32 and pi.spec_packs == 2
    params = pi.flat_params().clone().requires_grad_(True)
    specs = [pi.kernel_spec(torch.float64, CPU, params) for _ in range(2)]
    assert specs[0] is not specs[1] and specs[0].flat.requires_grad and pi.spec_packs == 4
    with torch.no_grad():
        kept = pi.kernel_spec(torch.float64, CPU, params)
        assert pi.kernel_spec(torch.float64, CPU, params) is kept
    listed = pi.flat_params().tolist()
    assert pi.kernel_spec(torch.float64, CPU, listed) is not pi.kernel_spec(torch.float64, CPU, listed)


def test_a_policy_that_packs_every_launch_or_params_that_are_no_tensor_keep_no_plan():
    env = _drive()
    cache = _cache()
    actor = ActorPolicy(2)
    assert actor.spec_packs is None and not cache.keep(_pmsm_key(env, actor, n_carry=1), "args", actor)
    pi = P.AffinePolicy(PI_K, Ki=PI_KI)
    key = _pmsm_key(env, pi, policy_params=pi.flat_params().tolist())
    assert not key.cacheable and not cache.keep(key, "args", pi)
    assert len(cache) == 0


def test_the_cache_keeps_at_most_its_bound_and_the_newest_plans():
    env = _drive()
    cache = _cache()
    policies = [P.AffinePolicy(PI_K, Ki=PI_KI) for _ in range(50)]
    for policy in policies:
        assert cache.keep(_pmsm_key(env, policy), "args", policy)
        assert len(cache) <= _PLANS_KEPT
    assert len(cache) == _PLANS_KEPT
    assert all(cache.find(_pmsm_key(env, p)) is not None for p in policies[-_PLANS_KEPT:])
    assert all(cache.find(_pmsm_key(env, p)) is None for p in policies[: -_PLANS_KEPT])
    # a plan kept again for its key takes the old one's place
    cache.keep(_pmsm_key(env, policies[-1]), "again", policies[-1])
    assert len(cache) == _PLANS_KEPT and cache.find(_pmsm_key(env, policies[-1])).args == "again"
    checks = []
    for policy in policies:
        assert cache.in_scope(Key().env(_drive(), env.env_properties, env._solver), lambda: checks.append(1) or True)
    assert len(checks) == 50 and len(cache._scoped) <= _PLANS_KEPT


def test_a_plan_keeps_nothing_alive():
    """A plan holds what its key names weakly: a dropped environment and
    policy are collected, and the plan is found no more."""
    cache = _cache()

    def keep_one():
        env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
        pi.kernel_spec(torch.float32, CPU)
        cache.keep(_pmsm_key(env, pi), "args", pi)
        return weakref.ref(env), weakref.ref(pi)

    env_ref, policy_ref = keep_one()
    gc.collect()
    assert env_ref() is None and policy_ref() is None
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    assert cache.find(_pmsm_key(env, pi)) is None
    cache.keep(_pmsm_key(env, pi), "args", pi)
    assert len(cache) == 1  # the dead plan was dropped


def test_the_scope_check_runs_once_per_environment_and_again_after_a_change():
    env = _drive(per_batch=True)
    cache = _cache()
    calls = []
    check = lambda: calls.append(1) or PCL.supports_pmsm_fused_closed_loop(env)
    scope = lambda: Key().env(env, env.env_properties, env._solver)
    assert all(cache.in_scope(scope(), check) for _ in range(3)) and len(calls) == 1
    env.env_properties.static_params.u_dc.mul_(1.5)
    assert cache.in_scope(scope(), check) and len(calls) == 2
    env.env_properties.static_params.deadtime = 3  # out of the kernel's scope
    assert not cache.in_scope(scope(), check) and not cache.in_scope(scope(), check) and len(calls) == 4


def test_fits_takes_contiguous_leaves_of_the_plans_type_device_and_shape():
    leaves = (torch.zeros(B), torch.ones(B))
    assert fits(leaves, torch.float32, CPU, (B,))
    assert not fits(leaves, torch.float64, CPU, (B,))
    assert not fits(leaves, torch.float32, CPU, (B + 1,))
    assert not fits((torch.zeros(2 * B)[::2],), torch.float32, CPU, (B,))
    assert not fits((0.0,), torch.float32, CPU, (B,))



class _Args(ctypes.Structure):
    _fields_ = [("static", ctypes.c_double), ("leaf", ctypes.c_void_p)]


def _try_launch(cache, key, leaves, policy, slabs=(), spec_fn=None):
    """``cache.launch`` with a struct of one static and one per-chunk field;
    returns its result, the structs launched and the specs taken."""
    launched, specs = [], []

    def spec():
        specs.append(policy.kernel_spec(torch.float32, CPU))
        return specs[-1]

    def chunk(args):
        args.leaf = leaves[0].data_ptr()
        return ("out",), [leaves[0]]

    result = cache.launch(key, leaves, slabs, policy, spec_fn or spec, _Args, chunk,
                          lambda args, extra: launched.append((args.static, args.leaf, extra)))
    return result, launched, specs


def test_a_plan_launches_a_copy_of_its_struct_with_the_chunks_pointers():
    """A hit takes the policy's spec once, copies the kept struct (the kept
    one keeps no per-chunk pointer), writes the chunk's pointers, launches
    with the plan's ``extra`` and counts a hit."""
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    pi.kernel_spec(torch.float32, CPU)
    cache = _cache()
    kept = _Args(static=2.5)
    assert cache.keep(_pmsm_key(env, pi), kept, pi, extra="detail")
    leaves = (torch.zeros(B), torch.ones(B))
    (outputs, spec), launched, specs = _try_launch(cache, _pmsm_key(env, pi), leaves, pi,
                                                   slabs=((None, (64, B, 1)), (torch.zeros(64, B, 2), (64, B, 2))))
    assert outputs == ("out",) and spec is specs[0] and len(specs) == 1
    assert launched == [(2.5, leaves[0].data_ptr(), "detail")] and kept.leaf is None
    assert cache.counts == {"hits": 1, "misses": 0}


def test_a_plan_leaves_to_the_full_path_what_it_cannot_launch():
    """No plan, leaves or a slab that do not fit, a policy that packed a new
    spec or a launch autograd records: nothing is launched, and where the
    spec was taken it is handed to the full path."""
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    pi.kernel_spec(torch.float32, CPU)
    cache = _cache()
    leaves = (torch.zeros(B), torch.ones(B))
    assert _try_launch(cache, None, leaves, pi)[0] == (None, None)
    assert _try_launch(cache, _pmsm_key(env, pi), leaves, pi)[0] == (None, None)  # nothing kept
    cache.keep(_pmsm_key(env, pi), _Args(), pi)
    for bad in ((torch.zeros(B), torch.ones(B + 1)), (torch.zeros(B), torch.ones(B, dtype=torch.float64)),
                (torch.zeros(2 * B)[::2], torch.ones(B))):
        assert _try_launch(cache, _pmsm_key(env, pi), bad, pi)[0] == (None, None)
    slab = ((torch.zeros(64, B, 1), (64, B, 2)),)
    assert _try_launch(cache, _pmsm_key(env, pi), leaves, pi, slabs=slab)[0] == (None, None)
    (outputs, spec), launched, specs = _try_launch(cache, _pmsm_key(env, pi), (leaves[0].requires_grad_(True),
                                                                                leaves[1]), pi)
    assert outputs is None and spec is specs[0] and not launched
    leaves[0].requires_grad_(False)
    pi.Ki = pi.Ki * 2.0  # a new spec: the plan's is stale
    (outputs, spec), launched, specs = _try_launch(cache, _pmsm_key(env, pi), leaves, pi)
    assert outputs is None and spec is specs[0] and not launched
    assert cache.counts == {"hits": 0, "misses": 0}


def test_a_miss_is_counted_and_kept_unless_a_static_leaf_was_copied():
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    pi.kernel_spec(torch.float32, CPU)
    cache = _cache()
    ptr = Pointers()
    strided = torch.zeros(2 * B)[::2]
    assert ptr(torch.ones(B)) and not ptr.copied and len(ptr.keep) == 1
    assert ptr(strided) != strided.data_ptr() and ptr.copied and ptr.keep[-1].is_contiguous()
    assert not cache.missed(_pmsm_key(env, pi), _Args(), pi, ptr)
    assert not cache.missed(None, _Args(), pi, Pointers())
    assert cache.missed(_pmsm_key(env, pi), _Args(), pi, Pointers(), extra="detail")
    assert cache.find(_pmsm_key(env, pi)).extra == "detail"
    assert cache.counts == {"hits": 0, "misses": 3} and len(cache) == 1

def test_the_entry_points_run_their_plain_loops_through_the_scope_memo_on_the_cpu():
    """On CPU tensors the entry points take the plain loop; the scope check
    they keep answers a second call without running again and still
    refuses an environment out of scope."""
    env = _drive()
    _, state = env.vmap_reset()
    state.reference.i_d = torch.linspace(-200.0, -10.0, B)
    state.reference.i_q = torch.linspace(-150.0, 150.0, B)
    pi = P.AffinePolicy(PI_K)
    first = env.fused_closed_loop(state, pi, 4)
    again = env.fused_closed_loop(state, pi, 4)
    assert torch.equal(first[0], again[0])
    env.env_properties.static_params.deadtime = 2
    with pytest.raises(ValueError, match="out of kernel scope"):
        env.fused_closed_loop(state, pi, 4)


def test_a_kept_plan_launches_its_instantiation_every_chunk_without_choosing_again(monkeypatch):
    """The full path picks the affine law's instantiation once and keeps it
    in its plan; every launch through the plan runs and counts that
    instantiation (``VARIANT_LAUNCHES``) without reading the gains again.
    On the CPU the launch is a stand-in; the card runs the real one
    (``tests/test_torch_gpu.py``)."""
    env, pi = _drive(), P.AffinePolicy(PI_K, Ki=PI_KI)
    n_steps = 64
    _, state = env.vmap_reset()
    phys = state.physical_state
    state0 = tuple(t.float() for t in (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer))
    omega, refs, carry = phys.omega_el.float(), (torch.zeros(B),) * 2, (torch.zeros(B),) * 2
    pi.kernel_spec(torch.float32, CPU)
    PCL.PLANS.clear()
    kept = PCL.PmsmClArgs(affine_columns=1)
    assert PCL.PLANS.keep(_pmsm_key(env, pi), kept, pi, extra=(PCL.kernel_variant(pi), ""))
    launched, chosen = [], []
    monkeypatch.setattr(PCL.PMSM_CL_KERNEL, "launch", lambda args, *a, **k: launched.append(args.affine_columns))
    monkeypatch.setattr(PCL, "kernel_variant", lambda *a: chosen.append(1) or "affine_all")
    before = dict(PCL.VARIANT_LAUNCHES)
    for _ in range(3):
        PCL.kernel_pmsm_closed_loop(env, state0, omega, pi, n_steps, tau=env.tau, solver=env._solver,
                                    props=env.env_properties, ref_leaves=refs, policy_carry=carry)
    PCL.PLANS.clear()
    assert launched == [1, 1, 1] and chosen == []
    assert PCL.VARIANT_LAUNCHES["affine_currents"] - before["affine_currents"] == 3
    assert PCL.VARIANT_LAUNCHES["affine_all"] == before["affine_all"]
