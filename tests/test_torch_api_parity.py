"""The port's public surface against the JAX package's, and the three API
faults that such a comparison found.

For every module of the JAX package that the port has ported, every public
class and function (``__all__``, else the public functions and classes the
module defines) has a counterpart of the same name in the port's module of
the same path, with the same parameter names in the same order
(``inspect.signature`` on both sides; for a class, every public method and
``__init__``).  The differences the port keeps on purpose are listed below,
each with its reason; modules still to port are listed as pending.
"""

import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils.convert import state_from_numpy

ROOT = Path(__file__).resolve().parents[1]
F64 = dict(device="cpu", dtype=torch.float64)

#: JAX modules (relative to the package) with no counterpart yet
PENDING = {
    "wrappers": "GymWrapper, GymnasiumVectorEnv and MujucoWrapper: the next slice",
    "parallel": "ShardedEnv and the metrics merge: the scale-out slice",
    "io": "the dataset writer and loaders: the data-path slice",
    "utils.fleet": "FleetRunner: the scale-out slice",
    "io.__main__": "the dataset CLI: the data-path slice",
}
#: JAX modules whose functions the port replaces by a module of another design
REDESIGNED = {
    "ops.pallas": "the Pallas kernels' launchers; the port's hand-written kernels have their own wrappers in "
                  "ops/kernels/ (PERF.md section 6), reached through the same environment entry points",
}
#: JAX names with no counterpart, by design
TPU_ONLY_NAMES = {
    "create_in_axes_dataclass": "jax.vmap in_axes trees; the port's methods work elementwise over tensors",
    "pytree_dataclass": "JAX pytree registration; the port's containers are plain dataclasses",
    "cached_jit": "a jax.jit cache; the port runs eagerly",
    "jitted_reset": "a jax.jit-compiled reset; the port runs eagerly",
    "unwrap_sharded": "ShardedEnv (parallel/mesh.py) is not ported yet; the planners take a plain environment",
}
#: JAX parameters the port drops everywhere
TPU_ONLY_PARAMS = {
    "interpret": "Pallas interpret mode; on CPU tensors the port runs each kernel's plain version",
    "gather": "the TPU kernels' MXU gather encodings (_split_int8x4, _split_bf16x3); the CUDA kernels have one",
    "vmap_helper": "jax.vmap's batch marker; the port's init_state takes batch_shape instead",
}
#: parameters the port adds at the end of a signature, by (module, qualified name)
PORT_ADDITIONS = {
    ("core.env", "CoreEnvironment.__init__"): ("device", "dtype"),
    ("core.classic", "ClassicODEEnvironment.__init__"): ("device", "dtype"),
    ("models.pmsm.pmsm_env", "PMSM.__init__"): ("device", "dtype"),
    ("ops.lut", "StackedBilinearLUT.__init__"): ("device", "dtype"),
    ("ops.lut", "build_pmsm_lut"): ("device", "dtype"),
    ("ops.adaptive", "adaptive_solve"): ("device",),
    ("ops.signals", "white_uniform"): ("dtype",),
    ("ops.signals", "aprbs"): ("dtype",),
    ("ops.signals", "chirp"): ("device", "dtype"),
    ("ops.signals", "multisine"): ("dtype",),
    ("utils.randomize", "sample_field"): ("dtype",),
    ("utils.randomize", "sample_static_params"): ("dtype",),
}
#: parameters renamed on purpose, by (module, qualified name): (JAX names, port names, reason)
RENAMED = {
    ("core.env", "CoreEnvironment.init_state"): (("vmap_helper",), ("batch_shape",), "the batch shape of the state"),
    ("core.classic", "ClassicODEEnvironment.init_state"): (("vmap_helper",), ("batch_shape",), "as above"),
    ("models.pmsm.pmsm_env", "PMSM.init_state"): (("vmap_helper",), ("batch_shape",), "as above"),
    ("core.spaces", "Space.sample"): (("rng",), ("generator",), "a torch.Generator draws the sample"),
    ("core.spaces", "Box.sample"): (("rng",), ("generator",), "as above"),
    ("ops.lut", "StackedBilinearLUT.interpolate_all"): (("point",), ("px", "py"),
                                                        "the point's coordinates as two tensors of any shape"),
}


def _modules():
    out = []
    pkg = ROOT / "exciting_environments_tpu"
    for path in sorted(pkg.rglob("*.py")):
        rel = ".".join(path.relative_to(pkg).with_suffix("").parts)
        rel = rel[: -len("__init__")].rstrip(".") if rel.endswith("__init__") else rel
        if any(rel == p or rel.startswith(p + ".") for p in (*PENDING, *REDESIGNED)):
            continue
        out.append(rel)
    return out


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, o in vars(mod).items() if not n.startswith("_") and (inspect.isfunction(o) or
                 inspect.isclass(o)) and getattr(o, "__module__", None) == mod.__name__]
    return sorted(names)


def _params(fn):
    fn = fn.__func__ if hasattr(fn, "__func__") else fn
    return [p for p in inspect.signature(fn).parameters]


def _methods(cls):
    for name, obj in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        fn = obj.__func__ if isinstance(obj, (staticmethod, classmethod)) else obj
        if isinstance(fn, property) or not callable(fn):
            continue
        yield name, fn


def _expected(rel, qualname, jax_params):
    """The port's parameter list the JAX one implies: TPU-only parameters
    dropped, the listed renames and additions applied."""
    old, new = RENAMED.get((rel, qualname), ((), (), None))[:2]
    out = []
    for p in jax_params:
        if p in old:
            out += list(new) if p == old[0] else []
        elif p not in TPU_ONLY_PARAMS:
            out.append(p)
    return out + list(PORT_ADDITIONS.get((rel, qualname), ()))


def _import(prefix, rel):
    return importlib.import_module(prefix + ("." + rel if rel else ""))


@pytest.mark.parametrize("rel", _modules())
def test_ported_module_has_the_jax_surface(rel):
    jm, pm = _import("exciting_environments_tpu", rel), _import("exciting_environments_torch", rel)
    problems = []
    for name in _public(jm):
        if name in TPU_ONLY_NAMES:
            continue
        if not hasattr(pm, name):
            problems.append(f"missing {name}")
            continue
        jo, po = getattr(jm, name), getattr(pm, name)
        pairs = []
        if inspect.isclass(jo):
            for meth, fn in _methods(jo):
                if meth in TPU_ONLY_NAMES:
                    continue
                if not hasattr(po, meth):
                    problems.append(f"missing {name}.{meth}")
                    continue
                pairs.append((f"{name}.{meth}", fn, getattr(po, meth)))
        elif callable(jo):
            pairs.append((name, jo, po))
        for qualname, jf, pf in pairs:
            want, got = _expected(rel, qualname, _params(jf)), _params(pf)
            if want != got:
                problems.append(f"{qualname}: JAX {_params(jf)} implies {want}, port has {got}")
    assert not problems, problems


def test_the_allow_lists_name_real_differences():
    """Every renamed or added entry still differs in the JAX package (an
    entry that no longer applies is removed, not kept)."""
    for (rel, qualname), (old, _new, _why) in RENAMED.items():
        owner, _, meth = qualname.rpartition(".")
        jf = getattr(getattr(_import("exciting_environments_tpu", rel), owner), meth)
        assert set(old) <= set(_params(jf)), (rel, qualname)
    for (rel, qualname), added in PORT_ADDITIONS.items():
        owner, _, meth = qualname.rpartition(".")
        jm = _import("exciting_environments_tpu", rel)
        jf = getattr(getattr(jm, owner), meth) if owner else getattr(jm, meth)
        assert not set(added) & set(_params(jf)), (rel, qualname)
    listed = set(PENDING) | set(REDESIGNED)
    for rel in listed:
        assert (ROOT / "exciting_environments_tpu" / Path(*rel.split("."))).exists() or \
            (ROOT / "exciting_environments_tpu" / (Path(*rel.split(".")).as_posix() + ".py")).exists(), rel


# ---------------------------------------------------------------------------
# the three faults, each against the JAX package
# ---------------------------------------------------------------------------


PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _noisy_pair(name, batch=4):
    if name == "pendulum":
        kw = dict(process_noise={"omega": 0.5}, observation_noise={"theta": 0.02})
        return (J.Pendulum(batch_size=batch, tau=1e-2, **kw), P.Pendulum(batch_size=batch, tau=1e-2, **kw, **F64),
                np.zeros((batch, 6, 1)) + 0.3)
    kw = dict(process_noise={"i_d": 2.0, "i_q": 2.0}, observation_noise={"i_d": 0.5, "i_q": 0.5})
    return (J.PMSM(batch_size=batch, **kw), P.PMSM(batch_size=batch, **kw, **F64),
            np.zeros((batch, 6, 2)) + np.array([0.2, -0.1]))


@pytest.mark.parametrize("name", ["pendulum", "pmsm"])
def test_vmap_generate_state_from_observation_takes_keys(name):
    """Fault 1: the rebuilt state carries the given keys, and a noisy
    rollout continued from it equals the JAX package's from the same keys
    (normals agree to ``erfinv``'s last bits, ROADMAP Accepted)."""
    je, pe, acts = _noisy_pair(name)
    B = acts.shape[0]
    _, js = je.vmap_reset(jax.random.split(jax.random.PRNGKey(1), B))
    obs = np.array(jax.vmap(je.generate_observation, in_axes=(0, je.in_axes_env_properties))(js, je.env_properties))
    jkeys = jax.random.split(jax.random.PRNGKey(7), B)
    pkeys = torch.as_tensor(np.asarray(jkeys).astype(np.int64))
    js2 = je.vmap_generate_state_from_observation(jnp.asarray(obs), jkeys)
    ps2 = pe.vmap_generate_state_from_observation(torch.as_tensor(obs), key=pkeys)
    assert torch.equal(ps2.PRNGKey, pkeys)
    names = PMSM_FIELDS if name == "pmsm" else ("theta", "omega")
    for n in names:
        np.testing.assert_allclose(getattr(ps2.physical_state, n).numpy(), np.asarray(getattr(js2.physical_state, n)),
                                   rtol=1e-13, atol=1e-13)
    jo, jlast = je.vmap_rollout(js2, jnp.asarray(acts))
    po, plast = pe.vmap_rollout(ps2, torch.as_tensor(acts))
    # measured 1.3e-14 (pendulum), 2.7e-14 (pmsm)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(plast.PRNGKey.numpy(), np.asarray(jlast.PRNGKey).astype(np.int64))


def test_pmsm_generate_interpolators_and_lut_matches_jax():
    """Fault 2: the reference-compatible LUT pipeline entry on the port's
    PMSM: the processed tables equal the JAX package's at 0.0 (float64), and
    the interpolators agree."""
    jd = J.PMSM(batch_size=2, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    pd = P.PMSM(batch_size=2, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    raw = P.MotorVariant.BRUSA.get_params().pmsm_lut
    interp_j, proc_j = jd.generate_interpolators_and_lut(J.MotorVariant.BRUSA.get_params().pmsm_lut)
    interp_p, proc_p = pd.generate_interpolators_and_lut(raw)
    assert set(proc_p) == set(proc_j) and set(interp_p) == set(interp_j)
    for q in interp_j:
        np.testing.assert_array_equal(np.asarray(proc_p[q], dtype=np.float64), np.asarray(proc_j[q], dtype=np.float64))
    pts = np.array([[-120.0, 35.0, 0.0, -300.0], [80.0, -10.0, 0.0, 250.0]])
    for q in interp_j:
        got = interp_p[q](torch.as_tensor(pts)).numpy().ravel()
        want = np.asarray(interp_j[q](jnp.asarray(pts))).ravel()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_pmsm_step_takes_action_by_the_jax_name():
    """Fault 3: ``pmsm.step(s, action=a, env_properties=p)`` for one drive,
    equal to the JAX package's; ``CoreEnvironment.step`` keeps
    ``action_norm``."""
    assert "action" in inspect.signature(P.PMSM.step).parameters
    assert "action_norm" in inspect.signature(P.CoreEnvironment.step).parameters
    je, pe = J.PMSM(batch_size=1), P.PMSM(batch_size=1, **F64)
    js = je.init_state(je.env_properties)
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n))[None] for n in PMSM_FIELDS})
    ps = P.core.structures.map_leaves(lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) else leaf, ps)
    a = np.array([0.3, -0.2])
    jo, js1 = je.step(js, action=jnp.asarray(a), env_properties=je.env_properties)
    po, ps1 = pe.step(ps, action=torch.as_tensor(a), env_properties=pe.env_properties)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-13, atol=1e-13)
