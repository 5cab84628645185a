"""Regular-grid lookup tables for saturated motor magnetics (counterpart of
``exciting_environments_tpu/ops/lut.py``).

The six flux/inductance maps of a measured machine share one uniform grid, so
they are stacked into one ``(C, nx, ny)`` tensor and interpolated with one
gather of the four cell corners and one bilinear blend
(:class:`StackedBilinearLUT`).  Beyond the padded edges the cell index clamps
while the fractional weight keeps growing: the linear extrapolation of
``RegularGridInterpolator`` with ``fill_value=None``, constant here because
the padded edge cells are.

The host-side preparation (:func:`fill_nan_nearest`, :func:`pad_edges`) runs
once at construction in numpy.  :class:`ScheduledLUT` holds further maps on
the same grid for the PMSM closed loop's scheduled gather.  The closed-loop
kernel reads both tables channel-interleaved (:func:`interleave_channels`,
built once per table).
"""

from __future__ import annotations

import numpy as np
import torch


def fill_nan_nearest(grid: np.ndarray) -> np.ndarray:
    """Replace NaNs by the value of the nearest (index-space) valid grid point
    (the reference's ``griddata`` nearest fill, ``pmsm_env.py:333-340``)."""
    grid = np.array(grid, dtype=np.float64, copy=True)
    nan_mask = np.isnan(grid)
    if not nan_mask.any():
        return grid
    valid_idx = np.argwhere(~nan_mask)
    nan_idx = np.argwhere(nan_mask)
    d2 = ((nan_idx[:, None, :] - valid_idx[None, :, :]) ** 2).sum(-1)
    nearest = valid_idx[np.argmin(d2, axis=1)]
    grid[nan_mask] = grid[nearest[:, 0], nearest[:, 1]]
    return grid


def pad_edges(grid: np.ndarray) -> np.ndarray:
    """Duplicate the border rows/columns once so that the linear extrapolation
    beyond the measured range is constant (``pmsm_env.py:342-346``)."""
    a = np.vstack([grid[0, :], grid, grid[-1, :]])
    return np.hstack([a[:, :1], a, a[:, -1:]])


def bilinear_gather(values, x0, dx, y0, dy, nx, ny, px, py):
    """Stacked bilinear gather of all ``C`` channels at points ``(px, py)``.

    ``values`` is ``(C, nx, ny)``; ``px``/``py`` are tensors of one shape
    ``S``, and the result is ``(C,) + S``.  ``x0``/``dx``/``y0``/``dy`` are
    Python numbers.  The operations and their order are those of the JAX
    function: the offset and the division by the grid step, ``floor``, the
    clamp to ``[0, n - 2]``, the conversion to integer, ``w = f - i`` in the
    working type, direct indexing of the four corners, and the blend summed
    left to right.
    """
    return _bilinear(lambda i, j: values[:, i, j], x0, dx, y0, dy, nx, ny, px, py)


def sliced_bilinear_gather(values, slices, x0, dx, y0, dy, nx, ny, px, py):
    """:func:`bilinear_gather` from a stack of tables ``(n_slices, C, nx,
    ny)``, each point from its own: ``slices`` is an integer tensor of the
    points' shape.  The same operations in the same order."""
    slices = slices.long()
    return _bilinear(lambda i, j: values[slices, :, i, j].movedim(-1, 0), x0, dx, y0, dy, nx, ny, px, py)


def _bilinear(corner, x0, dx, y0, dy, nx, ny, px, py):
    """The gather's arithmetic, ``corner(ix, iy)`` giving the ``(C,) + S``
    values of the cell corners."""
    fx = (px - x0) / dx
    fy = (py - y0) / dy
    ix = torch.clamp(torch.floor(fx), 0, nx - 2).long()
    iy = torch.clamp(torch.floor(fy), 0, ny - 2).long()
    wx = fx - ix
    wy = fy - iy
    v00 = corner(ix, iy)
    v01 = corner(ix, iy + 1)
    v10 = corner(ix + 1, iy)
    v11 = corner(ix + 1, iy + 1)
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * (1 - wx) * wy
        + v10 * wx * (1 - wy)
        + v11 * wx * wy
    )


def padded_channels(n_channels: int) -> int:
    """Channels of an interleaved table: ``n_channels`` rounded up to a
    multiple of 4, so that a grid point's channels fill whole 16-byte
    pieces in float32 (and in float64)."""
    return -(-n_channels // 4) * 4


def interleave_channels(values: torch.Tensor) -> torch.Tensor:
    """A stacked ``(C, nx, ny)`` table as ``(nx, ny, C_pad)``: the channels of
    one grid point contiguous, zero-padded to :func:`padded_channels`.  The
    layout the PMSM closed-loop kernel gathers from (a few 16-byte loads per
    cell corner in place of ``C`` scalar loads); the values are unchanged.
    A stack of slices ``(S, C, nx, ny)`` becomes ``S`` such tables one after
    the other, ``(S, nx, ny, C_pad)``."""
    if values.ndim == 4:
        return torch.stack([interleave_channels(v) for v in values])
    c, nx, ny = values.shape
    out = torch.zeros((nx, ny, padded_channels(c)), dtype=values.dtype, device=values.device)
    out[..., :c] = values.permute(1, 2, 0)
    return out


class StackedBilinearLUT:
    """Bilinear interpolation of ``C`` channels sharing one uniform 2-D grid.

    Args:
        x: uniform grid along the first point coordinate, ``(nx,)``.
        y: uniform grid along the second point coordinate, ``(ny,)``.
        values: stacked channel maps ``(C, nx, ny)`` (numpy).
        channel_names: names addressing the leading axis.
        device, dtype: where and in which type the table lives.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, values: np.ndarray, channel_names,
                 device=None, dtype: torch.dtype = torch.float32):
        self.x0 = float(x[0])
        self.y0 = float(y[0])
        self.dx = float(x[1] - x[0])
        self.dy = float(y[1] - y[0])
        self.nx = int(len(x))
        self.ny = int(len(y))
        self.values = torch.as_tensor(np.asarray(values), dtype=dtype, device=device).contiguous()
        self.channel_names = tuple(channel_names)
        self._index = {n: i for i, n in enumerate(self.channel_names)}
        self._interleaved = None

    def interleaved(self) -> torch.Tensor:
        """The table as :func:`interleave_channels` lays it out, built once."""
        if self._interleaved is None:
            self._interleaved = interleave_channels(self.values)
        return self._interleaved

    def interpolate_all(self, px, py):
        """Every channel at the points ``(px, py)``: ``(C,) + px.shape``."""
        return bilinear_gather(self.values, self.x0, self.dx, self.y0, self.dy, self.nx, self.ny, px, py)

    def channel(self, name: str):
        """A callable ``point (2, ...) -> (1, ...)`` for one channel, like the
        reference's per-quantity ``LUT_interpolators[q]``."""
        idx = self._index[name]

        def interp(point):
            return self.interpolate_all(point[0], point[1])[idx][None]

        return interp

    def as_dict(self):
        """Dict of per-channel callables (reference-compatible API)."""
        return {name: self.channel(name) for name in self.channel_names}


class ScheduledLUT:
    """Extra maps for the PMSM closed loop's scheduled gather (counterpart of
    ``exciting_environments_tpu/ops/pallas/pmsm_stepper.py::ScheduledLUT``).

    Each step of the closed loop gathers these channels on the drive's OWN
    magnetics grid at the policy's denormalized belief currents and appends
    them to the observation the policy sees; the gain-scheduled sensorless
    tile (``utils/foc.py``) reads its Kalman gains and magnetics this way.

    A fleet whose drives read different maps holds a stack of slices and
    each drive's slice: ``values`` ``(S, C, nx, ny)`` and ``slices`` ``(B,)``
    (the per-drive form of
    :func:`~exciting_environments_torch.utils.foc.make_pmsm_saturated_sensorless_current_tile`,
    one slice per distinct speed).

    Args:
        values: stacked channel maps ``(C, nx, ny)`` (numpy or a tensor) on
            exactly the grid of the environment's ``_lut``, or with
            ``slices`` a stack of them ``(S, C, nx, ny)``.
        carry_idx: ``(c0, c1)``, the positions of the NORMALIZED belief
            currents ``(i_d, i_q)`` in the policy carry; the loop
            denormalizes them with the ``i_d``/``i_q`` observation bands.
        slices: ``(B,)`` integer tensor, each drive's slice of ``values``
            (held as int32 on its device), or ``None``.
    """

    def __init__(self, values, carry_idx=(0, 1), slices=None):
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != (3 if slices is None else 4):
            raise ValueError("ScheduledLUT values must be (C, nx, ny), or (S, C, nx, ny) with slices")
        self.carry_idx = (int(carry_idx[0]), int(carry_idx[1]))
        self.slices = None
        if slices is not None:
            slices = torch.as_tensor(slices)
            if slices.ndim != 1 or slices.dtype.is_floating_point or slices.dtype == torch.bool:
                raise ValueError(f"ScheduledLUT slices must be a (B,) integer tensor, got {slices.dtype} "
                                 f"{tuple(slices.shape)}")
            if slices.numel() and not (0 <= int(slices.min()) and int(slices.max()) < self.values.shape[0]):
                raise ValueError(f"ScheduledLUT slices must index the {self.values.shape[0]} slices of values")
            self.slices = slices.to(torch.int32).contiguous()
        self._placed = {}

    @property
    def n_slices(self) -> int:
        """The slices of a per-drive stack; 0 for one table."""
        return 0 if self.slices is None else self.values.shape[0]

    def tensor(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The maps as a contiguous tensor in ``dtype`` on ``device`` (copied
        there once)."""
        key = (dtype, torch.device(device))
        if key not in self._placed:
            self._placed[key] = torch.as_tensor(self.values, dtype=dtype, device=device).contiguous()
        return self._placed[key]

    def interleaved(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The maps as :func:`interleave_channels` lays them out, in ``dtype``
        on ``device`` (built there once)."""
        key = ("interleaved", dtype, torch.device(device))
        if key not in self._placed:
            self._placed[key] = interleave_channels(self.tensor(dtype, device))
        return self._placed[key]

    def slice_plane(self, device) -> torch.Tensor:
        """``slices`` on ``device`` (copied there once), or ``None``."""
        if self.slices is None:
            return None
        key = ("slices", torch.device(device))
        if key not in self._placed:
            self._placed[key] = self.slices.to(device)
        return self._placed[key]

    def gather(self, dtype, device, lut, px, py):
        """Every channel at the points ``(px, py)`` on ``lut``'s grid, each
        drive from its own slice: ``(C,) + px.shape``."""
        values = self.tensor(dtype, device)
        if self.slices is None:
            return bilinear_gather(values, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
        return sliced_bilinear_gather(values, self.slice_plane(device), lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny,
                                      px, py)


SATURATED_QUANTITIES = ("L_dd", "L_dq", "L_qd", "L_qq", "Psi_d", "Psi_q")


def build_pmsm_lut(pmsm_lut: dict, device=None, dtype: torch.dtype = torch.float32):
    """Prepare a raw measured LUT dict into a :class:`StackedBilinearLUT`:
    NaN fill, edge padding, and a uniform padded grid from
    ``i_d_vec``/``i_q_vec`` (``pmsm_env.py:316-363``).  Returns ``(lut,
    processed_dict)``, the latter holding the padded per-quantity maps."""
    i_d_vec = np.asarray(pmsm_lut["i_d_vec"], dtype=np.float64)
    i_q_vec = np.asarray(pmsm_lut["i_q_vec"], dtype=np.float64)
    i_d_min, i_d_max = i_d_vec.min(), i_d_vec.max()
    i_q_min, i_q_max = i_q_vec.min(), i_q_vec.max()
    i_d_step = (i_d_max - i_d_min) / (i_d_vec.shape[1] - 1)
    i_q_step = (i_q_max - i_q_min) / (i_q_vec.shape[1] - 1)

    processed = dict(pmsm_lut)
    padded = []
    for q in SATURATED_QUANTITIES:
        qmap = pad_edges(fill_nan_nearest(np.asarray(pmsm_lut[q], dtype=np.float64)))
        processed[q] = qmap
        padded.append(qmap.T)  # (nx = i_d, ny = i_q) orientation

    n_y, n_x = processed[SATURATED_QUANTITIES[0]].shape
    x = np.linspace(i_d_min - i_d_step, i_d_max + i_d_step, n_x)
    y = np.linspace(i_q_min - i_q_step, i_q_max + i_q_step, n_y)
    lut = StackedBilinearLUT(x, y, np.stack(padded), SATURATED_QUANTITIES, device=device, dtype=dtype)
    return lut, processed
