"""Fused open-loop rollout: the counterpart of
``exciting_environments_tpu/ops/pallas/stepper.py`` (open-loop part).

The whole horizon of a classic environment's rollout runs in one launch of
the CUDA kernel in ``csrc/stepper.cu`` (one thread per instance, the state in
registers for all steps; see the note at the top of that file).  Beside it
lives the plain PyTorch version, :func:`plain_rollout`, a Python loop over
:func:`plain_step` that performs the kernel's arithmetic operation for
operation.  :func:`fused_rollout` takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

Two modes, as in the JAX package:

* **step mode** (:func:`env_fused_rollout`): identical to repeated
  ``vmap_step`` calls; FSAL solvers skip their carry-only last stage and the
  final solver carry is rebuilt on the host (:func:`_final_solver_state`);
* **sim-ahead mode** (:func:`env_fused_sim_ahead`): identical to
  ``vmap_sim_ahead``; the carry is never wrapped or clipped, stages at
  ``c == 1`` read the next zero-order-hold action, and each action is held
  for ``action_stepsize / obs_stepsize`` solver steps.

Actions enter the kernel NORMALIZED and are denormalized in-kernel with the
exact ``MinMaxNormalization.denormalize`` expression, so no pre-pass touches
the action slab.  An environment made with ``fast_math=True`` runs the
kernel's fast-math functors and angle wrap (the JAX kernel's ``fast_wrap``);
the plain version follows through the environment's own ``_sin``/``_cos``/
``_sign`` and ``_wrap_angles``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import _Components
from exciting_environments_torch.ops.solvers import ExplicitRungeKutta

MAX_STAGES = 7
MAX_STATE = 4
MAX_ACTION = 2
MAX_PARAMS = 8

_PKG = Path(__file__).resolve().parents[2]
#: CUDA sources; each ``csrc/<name>.cu`` builds into its own library
CSRC = _PKG / "csrc"
#: build directory of the kernel libraries (listed in .gitignore)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


class StepperArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct StepperArgs`` in ``csrc/stepper.cu``."""

    _fields_ = [
        ("tau", _c_double),
        ("a", (_c_double * MAX_STAGES) * MAX_STAGES),
        ("b", _c_double * MAX_STAGES),
        ("param_value", _c_double * MAX_PARAMS),
        ("act_min_value", _c_double * MAX_ACTION),
        ("act_max_value", _c_double * MAX_ACTION),
        ("param_ptr", _c_void_p * MAX_PARAMS),
        ("act_min_ptr", _c_void_p * MAX_ACTION),
        ("act_max_ptr", _c_void_p * MAX_ACTION),
        ("y0", _c_void_p * MAX_STATE),
        ("y_out", _c_void_p * MAX_STATE),
        ("traj", _c_void_p * MAX_STATE),
        ("actions", _c_void_p),
        ("noise", _c_void_p),
        ("batch", ctypes.c_longlong),
        ("n_steps", _c_int),
        ("n_stages", _c_int),
        ("hold", _c_int),
        ("sim_ahead", _c_int),
        ("wrap", _c_int * MAX_STATE),
        ("use_next", _c_int * MAX_STAGES),
        ("noise_idx", _c_int * MAX_STATE),
        ("n_noise", _c_int),
        ("traj_stride", _c_int),
        ("env_id", _c_int),
        ("fast", _c_int),
    ]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit")


def _library_path(name: str) -> Path:
    """Content-hashed library path of ``csrc/<name>.cu``: the hash covers the
    source, the shared headers and the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile ``csrc/<name>.cu`` (every source by default) into
    content-hashed shared libraries in :data:`BUILD_DIR`, one ``nvcc`` per
    missing library, all started together.  The compiler's resource report
    is kept beside each library as ``<name>.log``.  Returns ``{name: path}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    outs = {name: _library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {
            name: subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(Path(tmp) / out.name), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for name, out in todo.items()
        }
        failed = []
        for name, proc in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu:\n{stderr}")
                continue
            todo[name].with_suffix(".log").write_text(stdout + stderr)
            os.replace(Path(tmp) / todo[name].name, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build(name: str = "stepper") -> Path:
    """Compile ``csrc/<name>.cu`` at first use; returns the library's path."""
    return build_all([name])[name]


class KernelLibrary:
    """A kernel library built from ``csrc/<name>.cu`` and loaded with ctypes at
    first use, with its launch counts (one per mode).  The library exports
    ``<entry>_launch(args*, dtype, stream)``, which returns the CUDA error of
    the launch, and ``<entry>_args_size()``, checked against ``args_type``."""

    def __init__(self, name: str, entry: str, args_type, modes):
        self.name, self.entry, self.args_type = name, entry, args_type
        self._lib = None
        self.launches = {mode: 0 for mode in modes}

    def reset_counts(self):
        for mode in self.launches:
            self.launches[mode] = 0

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(build(self.name)))
            launch, size = getattr(lib, f"{self.entry}_launch"), getattr(lib, f"{self.entry}_args_size")
            launch.argtypes = [_c_void_p, _c_int, _c_void_p]
            launch.restype = _c_int
            size.argtypes = []
            size.restype = _c_int
            if size() != ctypes.sizeof(self.args_type):
                raise RuntimeError(f"{self.args_type.__name__} layout differs between Python and CUDA")
            self._lib = lib
        return self._lib

    def launch(self, args, dtype: torch.dtype, device: torch.device, mode: str, detail: str = ""):
        """Launch on the current stream of ``device``; a refused launch raises
        (it never runs, and only its return code reports it)."""
        stream = torch.cuda.current_stream(device).cuda_stream
        launch = getattr(self.lib(), f"{self.entry}_launch")
        rc = launch(ctypes.byref(args), 0 if dtype == torch.float32 else 1, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed with CUDA error {rc}{detail}")
        self.launches[mode] += 1


KERNEL = KernelLibrary("stepper", "stepper", StepperArgs, ("step", "sim_ahead"))


# ---------------------------------------------------------------------------
# tableau handling, shared by the kernel and the plain version
# ---------------------------------------------------------------------------


def _stage_rows(solver: ExplicitRungeKutta):
    """Stage rows and output weights that feed ``y1``: an FSAL method's last
    stage only seeds the next step, and both modes recompute it."""
    if solver.fsal:
        return solver.a[:-1], solver.b[:-1]
    return solver.a, solver.b


def _needs_next_action(solver: ExplicitRungeKutta) -> bool:
    """Whether an update-relevant stage sits at ``c == 1.0``."""
    a_rows, _ = _stage_rows(solver)
    return any(c == 1.0 for c in solver.c[1 : len(a_rows) + 1])


def _lincomb(yl, ks_leaf, coeffs, tau):
    acc = None
    for c, k in zip(coeffs, ks_leaf):
        if c == 0.0:
            continue
        term = k if c == 1.0 else c * k
        acc = term if acc is None else acc + term
    return yl if acc is None else yl + tau * acc


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def plain_step(env, solver, tau, params, sim_ahead, y, u, u_next=None, noise_row=None, noise_idx=()):
    """One step of the kernel's computation in plain PyTorch over ``(B,)``
    state leaves and a physical action row ``u`` ``(B, A)``."""

    def ode(yy, act):
        return env._ode(None, yy, params, lambda _t: _Components(act))

    a_rows, b = _stage_rows(solver)
    ks = [ode(y, u)]
    for row, c in zip(a_rows, solver.c[1:]):
        act = u_next if (u_next is not None and c == 1.0) else u
        yi = tuple(_lincomb(yl, [k[j] for k in ks], row, tau) for j, yl in enumerate(y))
        ks.append(ode(yi, act))
    y1 = tuple(_lincomb(yl, [k[j] for k in ks], b, tau) for j, yl in enumerate(y))
    if not sim_ahead:
        y1 = env._clip_state(env._wrap_angles(y1))
        if noise_idx:
            y1 = list(y1)
            for j, idx in enumerate(noise_idx):
                y1[idx] = y1[idx] + noise_row[:, j]
            y1 = env._clip_state(env._wrap_angles(tuple(y1)))
    return y1


def plain_rollout(env, y0, actions_tm, *, tau, solver=None, props=None, obs_stride=None,
                  sim_ahead=False, hold=1, noise_tm=None, noise_idx=()):
    """The kernel's rollout as a Python loop of :func:`plain_step` (argument
    contract: :func:`fused_rollout`, with time-major actions).  Runs on any
    device; :func:`fused_rollout` uses it for CPU tensors."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    n_rows = actions_tm.shape[0]
    n_steps = n_rows * hold
    has_next = sim_ahead and _needs_next_action(solver)
    y = tuple(y0)
    saves = []
    for t in range(n_steps):
        u = env.denormalize_action(actions_tm[t // hold], props)
        u_next = (
            env.denormalize_action(actions_tm[min((t + 1) // hold, n_rows - 1)], props) if has_next else None
        )
        y = plain_step(env, solver, tau, props.static_params, sim_ahead, y, u, u_next,
                       noise_row=None if noise_tm is None else noise_tm[t], noise_idx=noise_idx)
        if obs_stride is not None and (t + 1) % obs_stride == 0:
            saves.append(y)
    traj = tuple(torch.stack(leaf, dim=0) for leaf in zip(*saves)) if obs_stride is not None else None
    return y, traj


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _check_leaf(what, t, dtype, device, shape):
    if t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what} must be {dtype} on {device} with shape {tuple(shape)}, "
            f"got {t.dtype} on {t.device} with shape {tuple(t.shape)}"
        )


def kernel_rollout(env, y0, actions_tm, *, tau, solver=None, props=None, obs_stride=None,
                   sim_ahead=False, hold=1, noise_tm=None, noise_idx=()):
    """Launch the CUDA stepper kernel (argument contract: :func:`fused_rollout`,
    with time-major actions).  Outputs are allocated here; the launch is
    asynchronous on the current stream."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    y0 = tuple(y0)
    dtype, device = y0[0].dtype, y0[0].device
    batch = y0[0].shape[0]
    n_rows, n_action = actions_tm.shape[0], actions_tm.shape[-1]
    n_steps = n_rows * hold
    a_rows, b = _stage_rows(solver)
    n_params = len(env._kernel_params)

    if device.type != "cuda":
        raise ValueError(f"the stepper kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the stepper kernel takes float32 or float64, got {dtype}")
    if len(b) > MAX_STAGES or len(y0) > MAX_STATE or n_action > MAX_ACTION or n_params > MAX_PARAMS:
        raise ValueError("configuration exceeds the kernel's stage/state/action/parameter limits")
    if n_action != env.action_dim:
        raise ValueError(f"actions must have {env.action_dim} components, got {n_action}")
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    if noise_idx and sim_ahead:
        raise ValueError("process noise is step-mode only")
    if (noise_tm is not None) != bool(noise_idx):
        raise ValueError("noise_tm and noise_idx must be set together")
    for i, leaf in enumerate(y0):
        _check_leaf(f"state leaf {i}", leaf, dtype, device, (batch,))
    _check_leaf("actions", actions_tm, dtype, device, (n_rows, batch, n_action))
    grads = [*y0, actions_tm] + ([noise_tm] if noise_tm is not None else [])

    args = StepperArgs()
    keep = []  # tensors whose pointers the launch reads

    def ptr(t):
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    args.tau = float(tau)
    for s, row in enumerate(a_rows, start=1):
        for j, c in enumerate(row):
            args.a[s][j] = float(c)
    for j, c in enumerate(b):
        args.b[j] = float(c)
    for i, name in enumerate(env._kernel_params):  # the functor's parameter order
        leaf = getattr(props.static_params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            grads.append(leaf)
            args.param_ptr[i] = ptr(leaf)
        else:
            args.param_value[i] = float(leaf)
    for j, f in enumerate(structures.fields(props.action_normalizations)):
        norm = getattr(props.action_normalizations, f.name)
        for bound, vals, ptrs in (("min", args.act_min_value, args.act_min_ptr),
                                  ("max", args.act_max_value, args.act_max_ptr)):
            leaf = getattr(norm, bound)
            if isinstance(leaf, torch.Tensor):
                _check_leaf(f"action normalization {f.name}.{bound}", leaf, dtype, device, (batch,))
                grads.append(leaf)
                ptrs[j] = ptr(leaf)
            else:
                vals[j] = float(leaf)
    if any(t.requires_grad for t in grads):
        raise NotImplementedError(
            "the stepper kernel has no backward yet: its VJP (checkpointed recompute "
            "through plain_step) comes with the training slice, ROADMAP.md Queue 2 item 3"
        )

    y_out = [torch.empty(batch, dtype=dtype, device=device) for _ in y0]
    traj = (
        [torch.empty((n_steps // obs_stride, batch), dtype=dtype, device=device) for _ in y0]
        if obs_stride is not None else None
    )
    for i, leaf in enumerate(y0):
        args.y0[i] = ptr(leaf)
        args.y_out[i] = y_out[i].data_ptr()
        if traj is not None:
            args.traj[i] = traj[i].data_ptr()
    args.actions = ptr(actions_tm)
    if noise_tm is not None:
        _check_leaf("noise_tm", noise_tm, dtype, device, (n_steps, batch, len(noise_idx)))
        args.noise = ptr(noise_tm)
        for j, idx in enumerate(noise_idx):
            args.noise_idx[j] = idx
        args.n_noise = len(noise_idx)
    args.batch = batch
    args.n_steps = n_steps
    args.n_stages = len(b)
    args.hold = hold
    args.sim_ahead = int(sim_ahead)
    for i, name in enumerate(env._ode_state_fields):
        args.wrap[i] = int(name in env._angle_fields)
    if sim_ahead:
        for s, c in enumerate(solver.c[: len(b)]):
            args.use_next[s] = int(s > 0 and c == 1.0)
    args.traj_stride = obs_stride or 0
    args.env_id = env._kernel_env_id
    args.fast = int(getattr(env, "fast_math", False))

    KERNEL.launch(args, dtype, device, "sim_ahead" if sim_ahead else "step")
    return tuple(y_out), (tuple(traj) if traj is not None else None)


def fused_rollout(env, y0, actions, *, tau, solver=None, props=None, obs_stride=None,
                  time_major=False, sim_ahead=False, hold=1, noise_tm=None, noise_idx=()):
    """Run a whole horizon of fixed-``tau`` solver steps of ``env``'s vector
    field: the kernel for CUDA tensors, :func:`plain_rollout` for CPU tensors.

    Args:
        env: a classic environment with a kernel functor (``_kernel_env_id``).
        y0: tuple of ``(B,)`` state leaves in ``env._ode_state_fields`` order.
        actions: NORMALIZED actions ``(B, n_rows, A)``, or ``(n_rows, B, A)``
            with ``time_major=True`` (the layout the kernel reads; batch-major
            input costs a transposed copy of the slab).
        tau: solver step size.
        solver: explicit RK solver (default ``env._solver``).
        props: ``EnvProperties`` (default ``env.env_properties``).
        obs_stride: also return every ``obs_stride``-th post-step state.
        sim_ahead: trajectory-solve semantics (no wrap/clip of the carry,
            ``c == 1`` stages read the next action).
        hold: solver steps per action row (``n_steps = n_rows * hold``).
        noise_tm: pre-scaled process-noise increments ``(n_steps, B,
            len(noise_idx))``, added to the ``noise_idx`` leaves after
            wrap/clip (step mode only).

    Returns:
        ``(final, traj)``: a tuple of ``(B,)`` final leaves and, with
        ``obs_stride`` set, a tuple of ``(B, n_steps // obs_stride)`` saves
        (else ``None``).
    """
    actions_tm = actions if time_major else actions.transpose(0, 1)
    kwargs = dict(tau=tau, solver=solver, props=props, obs_stride=obs_stride,
                  sim_ahead=sim_ahead, hold=hold, noise_tm=noise_tm, noise_idx=tuple(noise_idx))
    if y0[0].device.type == "cuda":
        final, traj = kernel_rollout(env, y0, actions_tm.contiguous(), **kwargs)
    else:
        final, traj = plain_rollout(env, y0, actions_tm, **kwargs)
    return final, (tuple(s.transpose(0, 1) for s in traj) if traj is not None else None)


# ---------------------------------------------------------------------------
# scope and environment-level entry points
# ---------------------------------------------------------------------------


def sim_ahead_ratio(obs_stepsize: float, action_stepsize: float):
    """``action_stepsize / obs_stepsize`` as an exact small integer, else None."""
    r = action_stepsize / obs_stepsize
    R = int(round(r))
    if R >= 1 and abs(r - R) <= 1e-9 * R:
        return R
    return None


def supports_fused_rollout(env) -> bool:
    """Whether ``env`` is inside the stepper kernel's scope: a ported classic
    environment with a kernel functor and an explicit RK solver.  Per-batch
    leaves are validated to scalar or ``(batch_size,)`` at construction."""
    solver = env._solver
    return (
        getattr(env, "_kernel_env_id", None) is not None
        and isinstance(solver, ExplicitRungeKutta)
        and len(_stage_rows(solver)[1]) <= MAX_STAGES
        and len(env._ode_state_fields) == env.physical_state_dim <= MAX_STATE
        and env.action_dim <= MAX_ACTION
    )


def supports_fused_sim_ahead(env, obs_stepsize: float, action_stepsize: float) -> bool:
    """Kernel scope plus an integral stepsize ratio."""
    return supports_fused_rollout(env) and sim_ahead_ratio(obs_stepsize, action_stepsize) is not None


def _final_solver_state(env, y_final, last_action_phys, props):
    """The scan path's final solver carry: ``f(t1, y1)`` under the final
    action for FSAL methods, ``None`` otherwise."""
    if not env._solver.fsal:
        return None
    return env._vector_field(lambda t: last_action_phys)(env.tau, y_final, props.static_params)


def _broadcast_saves(leaf, n_saves):
    leaf = torch.as_tensor(leaf)
    return leaf[:, None].expand(leaf.shape[0], n_saves)


def env_fused_rollout(env, init_state, actions_norm, obs_stride: int = None,
                      time_major: bool = False, strict: bool = False):
    """Environment-level fused rollout: normalized actions in, ``(obs, state)``
    out, with the semantics of :meth:`CoreEnvironment.vmap_rollout`.  Falls
    back to the loop out of kernel scope (``strict=True`` raises instead).

    With ``obs_stride`` set, every ``obs_stride``-th observation is returned,
    shape ``(B, n_steps // obs_stride, obs_dim)``; otherwise only the final
    observation ``(B, obs_dim)``.
    """
    n_steps = actions_norm.shape[0] if time_major else actions_norm.shape[1]
    props = env.env_properties
    if not supports_fused_rollout(env):
        if strict:
            raise ValueError(
                "env_fused_rollout out of kernel scope (environment without a kernel "
                "functor, or solver family); strict=True forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, last_state = env.vmap_rollout(init_state, actions_norm, obs_stride or n_steps)
        return (obs[:, -1] if obs_stride is None else obs), last_state

    y0 = tuple(getattr(init_state.physical_state, n) for n in env._ode_state_fields)
    y_final, y_traj = fused_rollout(env, y0, actions_norm, tau=env.tau, props=props,
                                    obs_stride=obs_stride, time_major=time_major)
    last_action = env.denormalize_action(actions_norm[-1] if time_major else actions_norm[:, -1], props)
    batch = env.batch_size
    final_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_final))),
        additions=env.Additions(
            solver_state=_final_solver_state(env, y_final, last_action, props),
            active_solver_state=torch.ones(batch, dtype=torch.bool, device=y_final[0].device),
        ),
    )
    if obs_stride is None:
        return env.generate_observation(final_state, props), final_state

    n_saves = n_steps // obs_stride
    traj_state = structures.replace(
        final_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_traj))),
        PRNGKey=_broadcast_saves(init_state.PRNGKey, n_saves),
        additions=env.Additions(
            solver_state=None,
            active_solver_state=torch.ones((batch, n_saves), dtype=torch.bool, device=y_final[0].device),
        ),
        reference=structures.map_leaves(lambda leaf: _broadcast_saves(leaf, n_saves), init_state.reference),
    )
    return env.generate_observation(traj_state, env._props_for(props, 1)), final_state


def env_fused_sim_ahead(env, init_state, actions_norm, obs_stepsize: float, action_stepsize: float,
                        obs_stride: int = 1, time_major: bool = False, strict: bool = False):
    """Fused trajectory solve with :meth:`CoreEnvironment.vmap_sim_ahead`
    semantics: the solver steps on the observation grid, each action is held
    for ``action_stepsize / obs_stepsize`` steps, the carry is never wrapped
    or clipped, and ``c == 1`` stages read the next interval's action.

    Returns ``(observations, last_state)`` with observations of shape
    ``(B, 1 + total_steps // obs_stride, obs_dim)`` (initial observation
    included).  The full ``states`` trajectory is not materialized.
    """
    ratio = sim_ahead_ratio(obs_stepsize, action_stepsize)
    props = env.env_properties
    if not supports_fused_sim_ahead(env, obs_stepsize, action_stepsize):
        if strict:
            raise ValueError(
                "env_fused_sim_ahead out of kernel scope (environment support or "
                "non-integral stepsize ratio); strict=True forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, _, last_state = env.vmap_sim_ahead(init_state, actions_norm, obs_stepsize, action_stepsize)
        return obs[:, ::obs_stride], last_state

    n_actions = actions_norm.shape[0] if time_major else actions_norm.shape[1]
    n_steps = n_actions * ratio
    y0 = tuple(getattr(init_state.physical_state, n) for n in env._ode_state_fields)
    y_final_raw, y_traj_raw = fused_rollout(
        env, y0, actions_norm, tau=float(obs_stepsize), props=props, obs_stride=obs_stride,
        time_major=time_major, sim_ahead=True, hold=ratio,
    )
    # the reference wraps/clips the SAVED trajectory only
    y_final = env._clip_state(env._wrap_angles(y_final_raw))
    y_traj = env._clip_state(env._wrap_angles(y_traj_raw))

    batch = env.batch_size
    n_saves = n_steps // obs_stride
    device = y_final[0].device
    last_action = env.denormalize_action(actions_norm[-1] if time_major else actions_norm[:, -1], props)
    nan_ref = lambda shape: structures.map_leaves(
        lambda leaf: torch.full(shape, float("nan"), dtype=y_final[0].dtype, device=device),
        init_state.reference,
    )
    last_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_final))),
        additions=env.Additions(
            # FSAL carry from the raw (unwrapped) integration state
            solver_state=_final_solver_state(env, y_final_raw, last_action, props),
            active_solver_state=torch.ones(batch, dtype=torch.bool, device=device),
        ),
        reference=nan_ref((batch,)),
    )
    obs0 = env.generate_observation(init_state, props)
    traj_state = structures.replace(
        last_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_traj))),
        PRNGKey=_broadcast_saves(init_state.PRNGKey, n_saves),
        additions=env.Additions(
            solver_state=None,
            active_solver_state=torch.ones((batch, n_saves), dtype=torch.bool, device=device),
        ),
        reference=nan_ref((batch, n_saves)),
    )
    obs_traj = env.generate_observation(traj_state, env._props_for(props, 1))
    return torch.cat([obs0[:, None, :], obs_traj], dim=1), last_state
