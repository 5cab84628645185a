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
``_sign`` and ``_wrap_angles``.  The induction machine's and the EESM's
inverter limit (``u_dc=``, :func:`~exciting_environments_torch.core.classic.svm_circle`)
is computed in the kernel after the denormalization; the plain version
applies the environment's hook there (:func:`phys_action`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import _Components, with_env_properties
from exciting_environments_torch.ops.solvers import ExplicitRungeKutta
from exciting_environments_torch.utils.profiling import annotate

from . import checkpoint as ck

MAX_STAGES = 7
MAX_STATE = 4
MAX_ACTION = 3
MAX_PARAMS = 9

_PKG = Path(__file__).resolve().parents[2]
#: CUDA sources: library ``<name>`` is ``csrc/<name>.cu`` and every
#: ``csrc/<name>/*.cu`` (translation units compiled in parallel and linked
#: into one library)
CSRC = _PKG / "csrc"
#: build directory of the kernel libraries (listed in .gitignore)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: seconds of each ``nvcc`` of the last :func:`build_all` that compiled
#: anything, by source (``"<library>.so"`` for a link), and the whole build
BUILD_TIMES = {}

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
        ("svm_limit", _c_double),
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
        ("batch_major", _c_int),
    ]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit")


def library_sources(name: str) -> list:
    """The sources of library ``name``: ``csrc/<name>.cu``, then
    ``csrc/<name>/*.cu`` in name order."""
    return [CSRC / f"{name}.cu", *sorted((CSRC / name).glob("*.cu"))]


def _library_path(name: str) -> Path:
    """Content-hashed library path of library ``name``: the hash covers its
    sources, the shared headers and the compiler flags."""
    digest = hashlib.sha256()
    for path in library_sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(path.relative_to(CSRC).as_posix().encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _run_all(commands: dict, logs: Path) -> dict:
    """Run ``{key: argv}`` together, each with its output in ``logs/<n>.log``;
    returns ``{key: (returncode, output, seconds)}``."""
    logs.mkdir()
    procs, started = {}, {}
    for i, (key, argv) in enumerate(commands.items()):
        log = open(logs / f"{i}.log", "w")
        started[key] = time.perf_counter()
        procs[key] = (subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, text=True), log)
    done = {}
    while len(done) < len(procs):
        for i, (key, (proc, log)) in enumerate(procs.items()):
            if key not in done and proc.poll() is not None:
                seconds = time.perf_counter() - started[key]
                log.close()
                done[key] = (proc.returncode, (logs / f"{i}.log").read_text(), seconds)
        time.sleep(0.02)
    return done


def build_all(names=None) -> dict:
    """Compile the kernel libraries (every ``csrc/<name>.cu`` by default) into
    content-hashed shared libraries in :data:`BUILD_DIR`: one ``nvcc -c`` per
    source of every missing library, all started together, then one link
    per library.  The compiler's resource report is kept beside each library
    as ``<name>.log``; the times go to :data:`BUILD_TIMES`.  A failed
    compile or link raises.  Returns ``{name: path}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    outs = {name: _library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        objects = {name: [(src, tmp / f"{name}.{src.relative_to(CSRC).as_posix().replace('/', '.')}.o")
                          for src in library_sources(name)] for name in todo}
        compiled = _run_all({(name, src): [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                             for name, pairs in objects.items() for src, obj in pairs}, tmp / "compile")
        failed = [f"nvcc failed to build {src.relative_to(CSRC)}:\n{out}"
                  for (_, src), (rc, out, _) in compiled.items() if rc != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        times.update({src.relative_to(CSRC).as_posix(): sec for (_, src), (_, _, sec) in compiled.items()})
        linked = _run_all({name: [_nvcc(), "-shared", "-o", str(tmp / out.name), *(str(o) for _, o in objects[name])]
                           for name, out in todo.items()}, tmp / "link")
        for name, (rc, out, sec) in linked.items():
            if rc != 0:
                raise RuntimeError(f"nvcc failed to link {name}:\n{out}")
            times[f"{name}.so"] = sec
            report = "".join(compiled[(name, src)][1] for src, _ in objects[name])
            todo[name].with_suffix(".log").write_text(report)
            os.replace(tmp / todo[name].name, todo[name])
    BUILD_TIMES.clear()
    BUILD_TIMES.update(times, total=time.perf_counter() - t0)
    return outs


def build(name: str = "stepper") -> Path:
    """Compile library ``name`` at first use; returns its path."""
    return build_all([name])[name]


class KernelLibrary:
    """A kernel library built from its sources (:func:`library_sources`) and loaded with ctypes at
    first use, with its launch counts (one per mode).  The library exports
    ``<entry>_launch(args*, dtype, stream)``, which returns the CUDA error of
    the launch, and ``<entry>_args_size()``, checked against ``args_type``.
    Each launch is the span ``ee.launch.<name>.<mode>`` on a profiler's
    timeline, so a trace counts what :attr:`launches` counts."""

    def __init__(self, name: str, entry: str, args_type, modes):
        self.name, self.entry, self.args_type = name, entry, args_type
        self._lib = None
        self.launches = {mode: 0 for mode in modes}
        self._spans = {mode: f"ee.launch.{name}.{mode}" for mode in modes}

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
        with annotate(self._spans[mode]):
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


def phys_action(env, action_norm, props):
    """A normalized action row ``(..., A)`` as the kernels take it: denormalized,
    then the environment's action constraint (``_constrained_phys_action``;
    the kernels compute the inverter circle of :func:`kernel_svm_limit`)."""
    return env._constrained_phys_action(env.denormalize_action(action_norm, props))


def kernel_svm_limit(env):
    """The action constraint the stepper and closed-loop kernels compute for
    ``env``: ``0.0`` without one, the radius of the inverter circle for the
    hook of :func:`~exciting_environments_torch.core.classic.svm_circle`
    (its ``svm_limit``), ``None`` for any other hook (out of the kernels'
    scope; the plain versions run it on CPU tensors)."""
    hook = env._constrain_action_tuple
    return 0.0 if hook is None else getattr(hook, "svm_limit", None)


def plain_step(env, solver, tau, params, sim_ahead, y, u, u_next=None, noise_row=None, noise_idx=()):
    """One step of the kernel's computation in plain PyTorch over ``(B,)``
    state leaves and a physical (constrained) action row ``u`` ``(B, A)``."""

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
        u = phys_action(env, actions_tm[t // hold], props)
        u_next = phys_action(env, actions_tm[min((t + 1) // hold, n_rows - 1)], props) if has_next else None
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
                   sim_ahead=False, hold=1, noise_tm=None, noise_idx=(), batch_major=False):
    """Launch the CUDA stepper kernel (argument contract: :func:`fused_rollout`,
    with time-major actions ``(n_rows, B, A)``, or batch-major ones ``(B,
    n_rows, A)`` with ``batch_major=True``: the kernel reads either layout).
    Outputs are allocated here; the launch is asynchronous on the current
    stream.  Where autograd records the call (grad mode on and an input
    that requires grad), the launch is the forward of the checkpointed VJP
    (:class:`RolloutVJP`)."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    y0 = tuple(y0)
    dtype, device = y0[0].dtype, y0[0].device
    batch = y0[0].shape[0]
    n_rows, n_action = actions_tm.shape[1 if batch_major else 0], actions_tm.shape[-1]
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
    svm_limit = kernel_svm_limit(env)
    if svm_limit is None:
        raise ValueError("the stepper kernel computes no action constraint but the inverter circle (svm_circle)")
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    if noise_idx and sim_ahead:
        raise ValueError("process noise is step-mode only")
    if (noise_tm is not None) != bool(noise_idx):
        raise ValueError("noise_tm and noise_idx must be set together")
    for i, leaf in enumerate(y0):
        _check_leaf(f"state leaf {i}", leaf, dtype, device, (batch,))
    _check_leaf("actions", actions_tm, dtype, device, (batch, n_rows, n_action) if batch_major else
                (n_rows, batch, n_action))
    grads = [*y0, actions_tm] + ([noise_tm] if noise_tm is not None else [])

    args = StepperArgs()
    keep = []  # tensors whose pointers the launch reads

    def ptr(t):
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    args.tau = float(tau)
    args.svm_limit = svm_limit
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        return rollout_vjp(env, y0, actions_tm, tau=tau, solver=solver, props=props, obs_stride=obs_stride,
                           sim_ahead=sim_ahead, hold=hold, noise_tm=noise_tm, noise_idx=noise_idx,
                           batch_major=batch_major)

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
    args.batch_major = int(batch_major)

    KERNEL.launch(args, dtype, device, "sim_ahead" if sim_ahead else "step")
    return tuple(y_out), (tuple(traj) if traj is not None else None)


# ---------------------------------------------------------------------------
# the VJP: the kernel's forward with checkpoint saves, a segment replay back
# ---------------------------------------------------------------------------


class RolloutVJP(torch.autograd.Function):
    """The open-loop rollout as one differentiable operation, the counterpart
    of the JAX package's ``_fused_core`` ``custom_vjp``.

    Forward: the kernel on CUDA tensors, :func:`plain_rollout` on CPU
    tensors, both on detached inputs and with saves every
    :func:`~.checkpoint.ckpt_stride` steps (the raw carry in sim-ahead
    mode); the user's saves are a slice of them.  Backward: the segments in
    reverse, each replayed through :func:`plain_step` from its checkpoint
    (``_fused_core_bwd``).  A segment reads the action rows of its steps,
    and in sim-ahead mode with a ``c == 1`` stage the next row too: the
    next-action stream is the same slab one row on, so its cotangent lands
    on that row.  Inputs, after the configuration: the state leaves, the
    action slab (either layout), the floating tensor leaves of ``props``
    and the noise slab (or ``None``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        ctx.set_materialize_grads(False)
        y0, (slab,), pt, (noise,) = cfg.split(tensors)
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.obs_stride)
        kwargs = dict(tau=cfg.tau, solver=cfg.solver, props=ck.props_with(cfg.props, pt), obs_stride=ckpt,
                      sim_ahead=cfg.sim_ahead, hold=cfg.hold, noise_tm=noise, noise_idx=cfg.noise_idx)
        if y0[0].device.type == "cuda":
            final, saves = kernel_rollout(cfg.env, y0, slab, batch_major=cfg.batch_major, **kwargs)
        else:
            final, saves = plain_rollout(cfg.env, y0, slab.transpose(0, 1) if cfg.batch_major else slab, **kwargs)
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors[: cfg.n_in], *saves)
        if cfg.obs_stride is None:
            return tuple(final)
        skip = cfg.obs_stride // ckpt
        return tuple(final) + tuple(leaf[skip - 1 :: skip] for leaf in saves)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        y0, (slab,), pt, (noise,) = cfg.split(saved[: cfg.n_in])
        saves = saved[cfg.n_in :]
        env, ns, hold = cfg.env, len(y0), cfg.hold
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.obs_stride)
        n_seg = cfg.n_steps // ckpt
        g_y = list(grads[:ns])
        g_save = ck.inject(grads[ns:], cfg.obs_stride // ckpt, n_seg) if cfg.obs_stride else (None,) * ns
        y_starts = ck.starts(y0, saves)
        acts_tm = slab.transpose(0, 1) if cfg.batch_major else slab
        n_rows = acts_tm.shape[0]
        has_next = cfg.sim_ahead and _needs_next_action(cfg.solver)
        needs = ctx.needs_input_grad[1:]
        need_slab, need_pt, need_noise = needs[ns], needs[ns + 1 : ns + 1 + len(pt)], needs[-1]
        g_acts = torch.zeros_like(acts_tm) if need_slab else None
        g_noise = torch.zeros_like(noise) if need_noise else None
        g_pt = [None] * len(pt)
        at = lambda g, s: None if g is None else g[s]
        for s in reversed(range(n_seg)):
            t0, t1 = s * ckpt, (s + 1) * ckpt
            if s == n_seg - 1:
                g_y = [ck.add(g, at(gs, s)) for g, gs in zip(g_y, g_save)]
            # the saves at the segment's start enter as seeds of its start leaves
            seeds = [(j, at(gs, s - 1)) for j, gs in enumerate(g_save)] if s else []
            if all(g is None for g in (*g_y, *(g for _, g in seeds))):
                g_y = [ck.add(g, gs) for g, (_, gs) in zip(g_y, seeds)] if seeds else g_y
                continue
            r0 = t0 // hold
            r1 = (min(t1 // hold, n_rows - 1) if has_next else (t1 - 1) // hold) + 1

            def replay(*leaves, t0=t0, t1=t1, r0=r0, g_y=g_y):
                y, (a,), q, (nz,) = cfg.split(leaves)
                props = ck.props_with(cfg.props, q)
                for t in range(t0, t1):
                    u = phys_action(env, a[t // hold - r0], props)
                    u_next = phys_action(env, a[min((t + 1) // hold, n_rows - 1) - r0], props) if has_next else None
                    y = plain_step(env, cfg.solver, cfg.tau, props.static_params, cfg.sim_ahead, y, u, u_next,
                                   noise_row=None if nz is None else nz[t - t0], noise_idx=cfg.noise_idx)
                return list(zip(y, g_y))

            seg_inputs = [*(leaf[s] for leaf in y_starts), acts_tm[r0:r1], *pt,
                          None if noise is None else noise[t0:t1]]
            got = ck.segment_vjp(replay, seg_inputs, [True] * ns + [need_slab, *need_pt, need_noise], seeds)
            gy, (ga,), gq, (gn,) = cfg.split(got)
            g_y = list(gy)
            g_pt = [ck.add(a, b) for a, b in zip(g_pt, gq)]
            if ga is not None:
                g_acts[r0:r1] += ga
            if gn is not None:
                g_noise[t0:t1] = gn
        if g_acts is not None and cfg.batch_major:
            g_acts = g_acts.transpose(0, 1)
        return (None, *g_y, g_acts, *g_pt, g_noise)


def rollout_vjp(env, y0, slab, *, tau, solver=None, props=None, obs_stride=None, sim_ahead=False, hold=1,
                noise_tm=None, noise_idx=(), batch_major=False):
    """The rollout through :class:`RolloutVJP` (arguments as
    :func:`kernel_rollout`, on any device; returns as :func:`plain_rollout`)."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    y0 = tuple(y0)
    n_steps = slab.shape[1 if batch_major else 0] * hold
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    pt = ck.prop_tensors(props)
    cfg = ck.VJPConfig((len(y0), 1, len(pt), 1), env=env, n_steps=n_steps, tau=tau, solver=solver, props=props,
                       obs_stride=obs_stride, sim_ahead=sim_ahead, hold=hold, noise_idx=tuple(noise_idx),
                       batch_major=batch_major)
    out = RolloutVJP.apply(cfg, *y0, slab, *pt, noise_tm)
    ns = len(y0)
    return tuple(out[:ns]), (tuple(out[ns:]) if obs_stride is not None else None)


def _slab_layout(actions, time_major):
    """``(slab, batch_major)``: the action slab in a layout the kernel reads
    in place.  A slab contiguous in either orientation is passed as it lies
    (a transposed view of a contiguous slab is read in the other layout);
    only a slab contiguous in neither is copied."""
    tm = actions if time_major else actions.transpose(0, 1)
    if tm.is_contiguous():
        return tm, False
    bm = tm.transpose(0, 1)
    return (bm if bm.is_contiguous() else bm.contiguous()), True


def fused_rollout(env, y0, actions, *, tau, solver=None, props=None, obs_stride=None,
                  time_major=False, sim_ahead=False, hold=1, noise_tm=None, noise_idx=()):
    """Run a whole horizon of fixed-``tau`` solver steps of ``env``'s vector
    field: the kernel for CUDA tensors, :func:`plain_rollout` for CPU tensors.

    Args:
        env: a classic environment with a kernel functor (``_kernel_env_id``).
        y0: tuple of ``(B,)`` state leaves in ``env._ode_state_fields`` order.
        actions: NORMALIZED actions ``(B, n_rows, A)``, or ``(n_rows, B, A)``
            with ``time_major=True``; the kernel reads either layout in place
            (:func:`_slab_layout`).
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
    kwargs = dict(tau=tau, solver=solver, props=props, obs_stride=obs_stride,
                  sim_ahead=sim_ahead, hold=hold, noise_tm=noise_tm, noise_idx=tuple(noise_idx))
    if y0[0].device.type == "cuda":
        slab, batch_major = _slab_layout(actions, time_major)
        final, traj = kernel_rollout(env, y0, slab, batch_major=batch_major, **kwargs)
    else:
        run = rollout_vjp if ck.records_grad(y0, actions, kwargs, env.env_properties) else plain_rollout
        final, traj = run(env, y0, actions if time_major else actions.transpose(0, 1), **kwargs)
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


def kernel_env_scope(env) -> bool:
    """Whether the kernels have ``env``'s vector field: a ported classic
    environment with a kernel functor, an explicit RK solver and the
    kernels' stage, state and action limits.  Per-batch leaves are validated
    to scalar or ``(batch_size,)`` at construction."""
    solver = env._solver
    return (
        getattr(env, "_kernel_env_id", None) is not None
        and isinstance(solver, ExplicitRungeKutta)
        and len(_stage_rows(solver)[1]) <= MAX_STAGES
        and len(env._ode_state_fields) == env.physical_state_dim <= MAX_STATE
        and env.action_dim <= MAX_ACTION
    )


def supports_fused_rollout(env) -> bool:
    """Whether ``env`` is inside the stepper kernel's scope: its vector field
    (:func:`kernel_env_scope`) and no action constraint but the inverter
    circle the kernel computes (:func:`kernel_svm_limit`).  Another hook
    takes the loop (:meth:`CoreEnvironment.vmap_rollout`) on any device; the
    plain version, called directly, runs any hook."""
    return kernel_env_scope(env) and kernel_svm_limit(env) is not None


def supports_fused_sim_ahead(env, obs_stepsize: float, action_stepsize: float) -> bool:
    """Kernel scope plus an integral stepsize ratio, for a deterministic
    environment (a stochastic sim-ahead is the Euler-Maruyama loop of
    :meth:`CoreEnvironment.vmap_sim_ahead`)."""
    return (
        supports_fused_rollout(env)
        and not env._has_noise
        and sim_ahead_ratio(obs_stepsize, action_stepsize) is not None
    )


def _final_solver_state(env, y_final, last_action_phys, props):
    """The scan path's final solver carry: ``f(t1, y1)`` under the final
    action for FSAL methods, ``None`` otherwise."""
    if not env._solver.fsal:
        return None
    return env._vector_field(lambda t: last_action_phys)(env.tau, y_final, props.static_params)


def _broadcast_saves(leaf, n_saves):
    """A ``(B, ...)`` leaf repeated along a new save axis: ``(B, n_saves, ...)``."""
    leaf = torch.as_tensor(leaf)
    return leaf.unsqueeze(1).expand((leaf.shape[0], n_saves) + tuple(leaf.shape[1:]))


def traj_keys(init_key, keys_saves, n_saves):
    """The key leaf of batch-major trajectory saves ``(B, n_saves[, 2])``:
    a stochastic rollout's per-save keys ``keys_saves`` ``(n_saves, B, 2)``
    (each save carries its step's advanced key), else the initial key
    repeated."""
    if keys_saves is not None:
        return keys_saves.transpose(0, 1)
    return _broadcast_saves(init_key, n_saves)


def env_fused_rollout(env, init_state, actions_norm, obs_stride: int = None,
                      time_major: bool = False, strict: bool = False, return_traj_states: bool = False,
                      env_properties=None):
    """Environment-level fused rollout: normalized actions in, ``(obs, state)``
    out, with the semantics of :meth:`CoreEnvironment.vmap_rollout`.  Falls
    back to the loop out of kernel scope (``strict=True`` raises instead).

    With ``obs_stride`` set, every ``obs_stride``-th observation is returned,
    shape ``(B, n_steps // obs_stride, obs_dim)``; otherwise only the final
    observation ``(B, obs_dim)``.  ``return_traj_states`` (with
    ``obs_stride``, in kernel scope) returns ``(obs, traj_state,
    final_state)``, the saved states batch-major ``(B, n_saves)``.

    A stochastic environment's draws (:meth:`CoreEnvironment._noise_slabs`,
    either mode) are made first: the process increments, pre-scaled, go to
    the kernel as its noise slab, the sensor draws of the saved steps meet
    the observations, the final state carries the final keys and each saved
    state its step's advanced key.

    ``env_properties`` replaces ``env.env_properties`` for this launch (a
    shard's property slices, :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`).
    """
    env = with_env_properties(env, env_properties)
    n_steps = actions_norm.shape[0] if time_major else actions_norm.shape[1]
    props = env.env_properties
    if return_traj_states and obs_stride is None:
        raise ValueError("return_traj_states requires obs_stride")
    with annotate("ee.rollout.prepare"):
        in_scope = supports_fused_rollout(env)
        if in_scope:
            y0 = tuple(getattr(init_state.physical_state, n) for n in env._ode_state_fields)
            # a stochastic environment: the loop's draws, made first and streamed
            noise_tm, noise_idx, eps_obs, keys_saves, final_keys = env._noise_streams(init_state, n_steps,
                                                                                      obs_stride or n_steps)
            y_final, y_traj = fused_rollout(env, y0, actions_norm, tau=env.tau, props=props,
                                            obs_stride=obs_stride, time_major=time_major, noise_tm=noise_tm,
                                            noise_idx=noise_idx)
    if not in_scope:
        if strict or return_traj_states:
            raise ValueError(
                "env_fused_rollout out of kernel scope (environment without a kernel "
                "functor, solver family, or an action constraint the kernel does not "
                "compute); strict=True forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, last_state = env.vmap_rollout(init_state, actions_norm, obs_stride or n_steps)
        return (obs[:, -1] if obs_stride is None else obs), last_state

    with annotate("ee.rollout.rebuild"):
        last_action = phys_action(env, actions_norm[-1] if time_major else actions_norm[:, -1], props)
        batch = env.batch_size
        final_state = structures.replace(
            init_state,
            physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_final))),
            PRNGKey=init_state.PRNGKey if final_keys is None else final_keys,
            additions=env.Additions(
                solver_state=_final_solver_state(env, y_final, last_action, props),
                active_solver_state=torch.ones(batch, dtype=torch.bool, device=y_final[0].device),
            ),
        )
        if obs_stride is None:
            obs = env.generate_observation(final_state, props)
            return (obs if eps_obs is None else env._apply_observation_noise_eps(obs, props, eps_obs[-1])), final_state

        n_saves = n_steps // obs_stride
        traj_state = structures.replace(
            final_state,
            physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_traj))),
            PRNGKey=traj_keys(init_state.PRNGKey, keys_saves, n_saves),
            additions=env.Additions(
                solver_state=None,
                active_solver_state=torch.ones((batch, n_saves), dtype=torch.bool, device=y_final[0].device),
            ),
            reference=structures.map_leaves(lambda leaf: _broadcast_saves(leaf, n_saves), init_state.reference),
        )
        obs = env.generate_observation(traj_state, env._props_for(props, 1))
        if eps_obs is not None:
            obs = env._apply_observation_noise_eps(obs, props, eps_obs.transpose(0, 1), batch_major=True)
        return (obs, traj_state, final_state) if return_traj_states else (obs, final_state)


def env_fused_sim_ahead(env, init_state, actions_norm, obs_stepsize: float, action_stepsize: float,
                        obs_stride: int = 1, time_major: bool = False, strict: bool = False,
                        env_properties=None):
    """Fused trajectory solve with :meth:`CoreEnvironment.vmap_sim_ahead`
    semantics: the solver steps on the observation grid, each action is held
    for ``action_stepsize / obs_stepsize`` steps, the carry is never wrapped
    or clipped, and ``c == 1`` stages read the next interval's action.

    Returns ``(observations, last_state)`` with observations of shape
    ``(B, 1 + total_steps // obs_stride, obs_dim)`` (initial observation
    included).  The full ``states`` trajectory is not materialized.
    ``env_properties`` replaces ``env.env_properties`` for this launch.
    """
    env = with_env_properties(env, env_properties)
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
    last_action = phys_action(env, actions_norm[-1] if time_major else actions_norm[:, -1], props)
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
