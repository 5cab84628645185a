"""Fixed-step ODE solvers with an ``init``/``step`` carry protocol
(counterpart of ``exciting_environments_tpu/ops/solvers.py``): explicit
Runge-Kutta methods, the embedded pairs of Tsit5 and Dopri5
(:meth:`ExplicitRungeKutta.step_with_error`, for the adaptive controller of
:mod:`exciting_environments_torch.ops.adaptive`) and backward Euler with
Newton iterations (:class:`ImplicitEuler`).

States are tuples of tensors (one leaf per integrated field); the vector
field is a plain function ``f(t, y, args) -> dy``, elementwise over the
batch.  FSAL methods (Tsit5, Dopri5) carry ``f(t1, y1)`` between steps;
step-mode environment stepping re-``init``s it every step because the action
changes between calls.

The arithmetic is kept operation for operation: zero coefficients are
skipped, unit coefficients are not multiplied, the sum runs left to right and
is applied as ``y + h * acc``, so Euler is exactly ``y + h * f``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def _weighted_increment(y0, h, ks, coeffs):
    """``y0 + h * sum_i coeffs[i] * ks[i]`` leafwise over tuple states."""
    terms = [(c, k) for c, k in zip(coeffs, ks) if c != 0.0]
    if not terms:
        return y0

    def combine(y, *kleaves):
        acc = None
        for (c, _), k in zip(terms, kleaves):
            t = k if c == 1.0 else c * k
            acc = t if acc is None else acc + t
        return y + h * acc

    return tuple(combine(y, *kl) for y, *kl in zip(y0, *[k for _, k in terms]))


def stage_time(t0, c, h):
    """``t0 + c * h`` rounded in ``t0``'s own precision: a numpy scalar time
    (the host-side step grid of the trajectory engine) adds the Python
    product cast to its dtype, as a weakly typed JAX scalar would."""
    if c == 0.0:
        return t0
    if isinstance(t0, np.floating):
        return t0 + type(t0)(c * h)
    return t0 + c * h


class ODESolver:
    """Base class: fixed-step solver with a carry protocol."""

    num_stages: int = 1
    order: int = 1
    fsal: bool = False

    def init(self, f: Callable, t0, t1, y0, args):
        raise NotImplementedError

    def step(self, f: Callable, t0, t1, y0, args, carry, dt=None):
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"{type(self).__name__}()"


class ExplicitRungeKutta(ODESolver):
    """Explicit Runge-Kutta method defined by a Butcher tableau: ``a`` holds
    one row per stage after the first, ``b`` the output weights, ``c`` the
    stage times.  With ``fsal`` the last stage is ``f(t1, y1)``."""

    a: Sequence[Sequence[float]] = ()
    b: Sequence[float] = (1.0,)
    c: Sequence[float] = (0.0,)

    def __init__(self):
        self.num_stages = len(self.b)

    @property
    def one_stage(self) -> bool:
        """Structurally the exact ``y + h*f`` Euler update."""
        return len(self.b) == 1 and float(self.b[0]) == 1.0

    def init(self, f, t0, t1, y0, args):
        if self.fsal:
            return f(t0, y0, args)
        return None

    def step(self, f, t0, t1, y0, args, carry, dt=None):
        h = (t1 - t0) if dt is None else dt
        k1 = carry if self.fsal else f(t0, y0, args)
        ks = [k1]
        for i, row in enumerate(self.a):
            ti = stage_time(t0, self.c[i + 1], h)
            yi = _weighted_increment(y0, h, ks, row)
            ks.append(f(ti, yi, args))
        if self.fsal:
            # a[-1] == b, therefore the last stage value is y1
            return _weighted_increment(y0, h, ks[:-1], self.b[:-1]), ks[-1]
        return _weighted_increment(y0, h, ks, self.b), None

    #: embedded error weights ``b - bhat``; ``None`` without an embedded pair
    b_err = None

    def step_with_error(self, f, t0, t1, y0, args, dt=None, k0=None):
        """One step and its embedded local error estimate: ``(y1, err,
        k_end)`` with ``err = h * sum_i b_err[i] * k_i`` and ``k_end`` the last
        stage.  Under FSAL ``k_end = f(t0 + h, y1)``, which an accepted step
        passes back as the next step's ``k0`` (its first stage)."""
        if self.b_err is None:
            raise ValueError(f"{type(self).__name__} has no embedded error estimate")
        h = (t1 - t0) if dt is None else dt
        ks = [f(t0, y0, args) if k0 is None else k0]
        for i, row in enumerate(self.a):
            ks.append(f(stage_time(t0, self.c[i + 1], h), _weighted_increment(y0, h, ks, row), args))
        if self.fsal:
            y1 = _weighted_increment(y0, h, ks[:-1], self.b[:-1])
        else:
            y1 = _weighted_increment(y0, h, ks, self.b)
        zero = tuple(leaf * 0.0 for leaf in y0)
        return y1, _weighted_increment(zero, h, ks, self.b_err), ks[-1]


class Euler(ExplicitRungeKutta):
    """Explicit (forward) Euler, the default solver."""

    order = 1
    a = ()
    b = (1.0,)
    c = (0.0,)


class Midpoint(ExplicitRungeKutta):
    """Explicit midpoint rule (2nd order)."""

    order = 2
    a = ((0.5,),)
    b = (0.0, 1.0)
    c = (0.0, 0.5)


class Heun(ExplicitRungeKutta):
    """Heun's method / explicit trapezoidal rule (2nd order)."""

    order = 2
    a = ((1.0,),)
    b = (0.5, 0.5)
    c = (0.0, 1.0)


class RK4(ExplicitRungeKutta):
    """The classical 4th-order Runge-Kutta method."""

    order = 4
    a = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
    b = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
    c = (0.0, 0.5, 0.5, 1.0)


class Tsit5(ExplicitRungeKutta):
    """Tsitouras 5(4), FSAL, 7 stages (Tsitouras 2011)."""

    order = 5
    fsal = True
    c = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
    a = (
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401, -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
    )
    b = (
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    )
    b_err = (
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    )


class Dopri5(ExplicitRungeKutta):
    """Dormand-Prince 5(4), FSAL, 7 stages."""

    order = 5
    fsal = True
    c = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
    a = (
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    )
    b = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
    b_err = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)


class ImplicitEuler(ODESolver):
    """Backward Euler with a fixed number of Newton iterations on ``y - y0 -
    h f(t1, y)``, from the explicit Euler predictor, for stiff dynamics.

    The step is batched: its Jacobian is one ``(n, n)`` matrix per instance,
    ``(..., n, n)``, made of ``n`` forward-mode products with one-hot
    tangents along the state axis (exact, because the vector field is
    elementwise over the batch), and each Newton step is a batched
    ``torch.linalg.solve``."""

    order = 1
    num_stages = 1

    def __init__(self, newton_iters: int = 4):
        self.newton_iters = newton_iters

    def init(self, f, t0, t1, y0, args):
        return None

    def step(self, f, t0, t1, y0, args, carry, dt=None):
        h = (t1 - t0) if dt is None else dt
        leaves = [torch.as_tensor(leaf) for leaf in y0]
        shape = torch.broadcast_shapes(*(leaf.shape for leaf in leaves))
        y0_flat = torch.stack([leaf.expand(shape) for leaf in leaves], dim=-1)
        n = y0_flat.shape[-1]

        def f_flat(y_flat):
            dy = f(t1, tuple(y_flat.unbind(-1)), args)
            return torch.stack([torch.as_tensor(d, dtype=y_flat.dtype, device=y_flat.device).expand(shape)
                                for d in dy], dim=-1)

        def residual(y_flat):
            return y_flat - y0_flat - h * f_flat(y_flat)

        eye = torch.eye(n, dtype=y0_flat.dtype, device=y0_flat.device)
        y = y0_flat + h * f_flat(y0_flat)  # explicit predictor
        for _ in range(self.newton_iters):
            cols = [torch.func.jvp(residual, (y,), (eye[i].expand_as(y),))[1] for i in range(n)]
            jac = torch.stack(cols, dim=-1)  # jac[..., k, i] = d residual_k / d y_i
            y = y - torch.linalg.solve(jac, residual(y))
        return tuple(y.unbind(-1)), None


SOLVER_REGISTRY = {
    "euler": Euler,
    "midpoint": Midpoint,
    "heun": Heun,
    "rk4": RK4,
    "tsit5": Tsit5,
    "dopri5": Dopri5,
    "implicit_euler": ImplicitEuler,
}


def make_solver(name_or_solver):
    """Accept an :class:`ODESolver` instance, a registry name, or any object
    whose class name matches a registry entry (diffrax's ``ImplicitEuler()``
    spelling included)."""
    if isinstance(name_or_solver, ODESolver):
        return name_or_solver
    key = str(name_or_solver).lower()
    if key not in SOLVER_REGISTRY and not isinstance(name_or_solver, str):
        key = type(name_or_solver).__name__.lower()
        key = {"impliciteuler": "implicit_euler"}.get(key, key)
    if key not in SOLVER_REGISTRY:
        raise ValueError(f"unknown solver {name_or_solver!r}; known names: {sorted(SOLVER_REGISTRY)}")
    return SOLVER_REGISTRY[key]()
