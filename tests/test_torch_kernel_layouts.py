"""The data layouts and exact fast paths the redesigned kernels rely on, held
on the CPU against the functions they replace.

* The channel-interleaved tables of the PMSM closed-loop kernel
  (``ops/lut.py::interleave_channels``), read back by a plain gather with
  the kernel's indexing, equal ``bilinear_gather`` on the stacked table bit
  for bit: the BRUSA magnetics and the gain-scheduled tile's maps, at
  points inside, on the edge cells and outside the grid.
* The floored remainder's fast path (``csrc/eager_rules.cuh::floored_mod``),
  mirrored in numpy, equals ``torch.remainder(x, 2 pi)`` bit for bit: over
  every float32 in [pi, 4 pi), over seeded samples in [-4 pi, 4 pi), and on
  signed zeros, infinities, NaN and the neighbours of the range's ends.
* The build layout: the stepper and closed-loop libraries are a source and
  one translation unit per environment (``csrc/<library>/*.cu``), and each
  library's content hash changes with any of its sources, any header and
  the flags, and with nothing else.
"""

import shutil

import math

import numpy as np
import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops.kernels import stepper as K
from exciting_environments_torch.ops.lut import bilinear_gather, interleave_channels, padded_channels
from exciting_environments_torch.utils import foc

DTYPES = [torch.float32, torch.float64]


def bilinear_gather_interleaved(table, n_channels, x0, dx, y0, dy, nx, ny, px, py):
    """The PMSM closed-loop kernel's gather (``csrc/pmsm_drive.cuh::
    gather_il``) in plain PyTorch: ``bilinear_gather``'s operations in the
    same order, each corner's channels read from one grid point of an
    ``interleave_channels`` table."""
    fx = (px - x0) / dx
    fy = (py - y0) / dy
    ix = torch.clamp(torch.floor(fx), 0, nx - 2).long()
    iy = torch.clamp(torch.floor(fy), 0, ny - 2).long()
    wx = fx - ix
    wy = fy - iy
    corner = lambda i, j: table[i, j, :n_channels].movedim(-1, 0)
    return (
        corner(ix, iy) * (1 - wx) * (1 - wy)
        + corner(ix, iy + 1) * (1 - wx) * wy
        + corner(ix + 1, iy) * wx * (1 - wy)
        + corner(ix + 1, iy + 1) * wx * wy
    )


def _brusa(dtype, batch=64):
    return P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu", dtype=dtype)


def _points(lut, dtype, n=4096, seed=0):
    """Gather points over the grid and a margin of a third of its span on
    each side (the edge cells and the clamped outside), plus every grid
    node, the last cell's far corner and the exact grid ends."""
    rng = np.random.default_rng(seed)
    x_lo, x_hi = lut.x0, lut.x0 + (lut.nx - 1) * lut.dx
    y_lo, y_hi = lut.y0, lut.y0 + (lut.ny - 1) * lut.dy
    px = rng.uniform(x_lo - (x_hi - x_lo) / 3, x_hi + (x_hi - x_lo) / 3, n)
    py = rng.uniform(y_lo - (y_hi - y_lo) / 3, y_hi + (y_hi - y_lo) / 3, n)
    gx, gy = np.meshgrid(lut.x0 + lut.dx * np.arange(lut.nx), lut.y0 + lut.dy * np.arange(lut.ny), indexing="ij")
    ends = np.array([[x_lo, y_lo], [x_hi, y_hi], [x_lo, y_hi], [x_hi, y_lo], [x_hi + lut.dx, y_hi + lut.dy]])
    px = np.concatenate([px, gx.ravel(), ends[:, 0]])
    py = np.concatenate([py, gy.ravel(), ends[:, 1]])
    return torch.as_tensor(px, dtype=dtype), torch.as_tensor(py, dtype=dtype)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interleaved_magnetics_gather_equals_bilinear_gather(dtype):
    lut = _brusa(dtype)._lut
    table = lut.interleaved()
    assert table.shape == (lut.nx, lut.ny, 8) and table.dtype == dtype and table.is_contiguous()
    assert lut.interleaved() is table  # built once per table
    px, py = _points(lut, dtype)
    got = bilinear_gather_interleaved(table, 6, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
    want = bilinear_gather(lut.values, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
    assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interleaved_scheduled_maps_gather_equals_bilinear_gather(dtype):
    env = _brusa(dtype)
    _, _, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std={"i_d": 3.0, "i_q": 3.0})
    lut = env._lut
    table = sched.interleaved(dtype, "cpu")
    assert table.shape == (lut.nx, lut.ny, 12) and sched.interleaved(dtype, "cpu") is table
    px, py = _points(lut, dtype, seed=1)
    got = bilinear_gather_interleaved(table, 10, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
    want = bilinear_gather(sched.tensor(dtype, "cpu"), lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
    assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interleave_keeps_values_and_zero_pads(dtype):
    values = torch.as_tensor(np.random.default_rng(2).normal(size=(10, 7, 5)), dtype=dtype)
    table = interleave_channels(values)
    assert [padded_channels(c) for c in (1, 4, 6, 10)] == [4, 4, 8, 12]
    assert table.shape == (7, 5, 12)
    assert _same_bits(table[..., :10], values.permute(1, 2, 0).contiguous())
    assert not bool(table[..., 10:].any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_points_fail_alike_in_both_gathers(dtype):
    """A NaN point has no cell: the plain gathers index with the integer
    conversion of NaN and both refuse it (the kernel's cell() reads cell 0
    and returns NaN values)."""
    lut = _brusa(dtype)._lut
    px = torch.tensor([0.0, math.nan], dtype=dtype)
    py = torch.tensor([math.nan, 0.0], dtype=dtype)
    args = (lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, px, py)
    with pytest.raises(IndexError):
        bilinear_gather(lut.values, *args)
    with pytest.raises(IndexError):
        bilinear_gather_interleaved(lut.interleaved(), 6, *args)


# ---------------------------------------------------------------------------
# the floored remainder's fast path
# ---------------------------------------------------------------------------

TWO_PI = 6.283185307179586


def floored_mod_fast(x: np.ndarray, m) -> np.ndarray:
    """csrc/eager_rules.cuh::floored_mod for m > 0, elementwise in x's type:
    x on [0, m), x - m on [m, 2m), x + m on (-m, 0), and np.fmod with the
    floored adjustment elsewhere."""
    m = x.dtype.type(m)
    with np.errstate(invalid="ignore"):
        r = np.fmod(x, m)
        r = np.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)
        r = np.where((x < 0) & (x > -m), x + m, r)
        r = np.where((x >= m) & (x < m + m), x - m, r)
        r = np.where((x >= 0) & (x < m), x, r)
    return r.astype(x.dtype)


def _check_against_torch(x: np.ndarray):
    got = floored_mod_fast(x, TWO_PI)
    want = torch.remainder(torch.from_numpy(x), TWO_PI).numpy()
    bits = {np.float32: np.int32, np.float64: np.int64}[x.dtype.type]
    mismatch = got.view(bits) != want.view(bits)
    assert not mismatch.any(), (x[mismatch][:5], got[mismatch][:5], want[mismatch][:5])


def test_floored_mod_fast_path_over_every_float32_from_pi_to_4pi():
    lo = np.array(np.pi, dtype=np.float32).view(np.int32)
    hi = np.array(4 * np.pi, dtype=np.float32).view(np.int32)
    x = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    assert x.size > 1 << 23
    _check_against_torch(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_floored_mod_fast_path_on_seeded_samples(dtype):
    x = np.random.default_rng(3).uniform(-4 * np.pi, 4 * np.pi, 1_000_000).astype(dtype)
    _check_against_torch(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_floored_mod_fast_path_on_special_values(dtype):
    m = dtype(TWO_PI)
    ends = np.array([m, m + m, -m, dtype(0)], dtype=dtype)
    near = np.concatenate([np.nextafter(ends, dtype(np.inf)), np.nextafter(ends, dtype(-np.inf)), ends])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.finfo(dtype).tiny, -np.finfo(dtype).tiny,
                        np.finfo(dtype).max, -np.finfo(dtype).max], dtype=dtype)
    x = np.concatenate([near, special, -near]).astype(dtype)
    got = floored_mod_fast(x, TWO_PI)
    want = torch.remainder(torch.from_numpy(x), TWO_PI).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    bits = {np.float32: np.int32, np.float64: np.int64}[dtype]
    finite = ~np.isnan(want)
    assert np.array_equal(got[finite].view(bits), want[finite].view(bits))


# ---------------------------------------------------------------------------
# the closed-loop actor's flat weights as ActorReg<16, 16> reads them
# ---------------------------------------------------------------------------


def _actor_offsets(n_in, h1, h2, n_action):
    """csrc/closed_loop.cu::ActorReg::prepare's offsets into the flat vector."""
    o_b0 = n_in * h1
    o_w1 = o_b0 + h1
    o_b1 = o_w1 + h1 * h2
    o_w2 = o_b1 + h2
    o_b2 = o_w2 + h2 * n_action
    return dict(o_b0=o_b0, o_w1=o_w1, o_b1=o_b1, o_w2=o_w2, o_b2=o_b2, o_std=o_b2 + n_action)


@pytest.mark.parametrize("n_in", [2, 3, 5, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_actor_flat_layout_and_16_byte_reads(n_in, dtype):
    """ActorPolicy.kernel_spec's flat vector read back at ActorReg's offsets
    gives every weight, bias, log_std and the seed; the rows ActorReg reads
    as 16-byte vectors start on 16-byte boundaries in both float types."""
    from exciting_environments_torch.utils.rl_fused import ActorPolicy

    rng = np.random.default_rng(n_in)
    sizes = (n_in, 16, 16, 1)
    layers = [{"w": torch.as_tensor(rng.normal(size=(m, n)), dtype=dtype),
               "b": torch.as_tensor(rng.normal(size=n), dtype=dtype)} for m, n in zip(sizes[:-1], sizes[1:])]
    params = {"actor": layers, "log_std": torch.full((1,), -1.0, dtype=dtype), "seed": 5.0}
    flat = ActorPolicy(1).kernel_spec(dtype, "cpu", params).flat
    o = _actor_offsets(n_in, 16, 16, 1)
    w0 = flat[: o["o_b0"]].reshape(n_in, 16)
    assert torch.equal(w0, layers[0]["w"]) and torch.equal(flat[o["o_b0"] : o["o_w1"]], layers[0]["b"])
    assert torch.equal(flat[o["o_w1"] : o["o_b1"]].reshape(16, 16), layers[1]["w"])
    assert torch.equal(flat[o["o_b1"] : o["o_w2"]], layers[1]["b"])
    assert torch.equal(flat[o["o_w2"] : o["o_b2"]].reshape(16, 1), layers[2]["w"])
    assert float(flat[o["o_std"]]) == -1.0 and float(flat[o["o_std"] + 1]) == 5.0
    assert flat.numel() == o["o_std"] + 2
    per_vector = 16 // flat.element_size()
    for name in ("o_b0", "o_w1", "o_b1", "o_w2"):
        assert o[name] % per_vector == 0, name


# ---------------------------------------------------------------------------
# the PMSM kernel's in-place read of either action layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_major", [False, True])
def test_pmsm_action_rows_are_read_in_place(batch_major):
    """csrc/pmsm_stepper.cu's row pointer (start b * 2 time-major or
    b * T * 2 batch-major, then one row stride per step) visits the same
    actions as the time-major slab, for every instance and step."""
    T, B = 7, 5
    acts_tm = torch.arange(T * B * 2, dtype=torch.float64).reshape(T, B, 2)
    slab = (acts_tm.transpose(0, 1) if batch_major else acts_tm).contiguous().reshape(-1)
    row_stride = 2 if batch_major else B * 2
    for b in range(B):
        start = b * T * 2 if batch_major else b * 2
        for r in range(T):
            at = start + r * row_stride
            assert torch.equal(slab[at : at + 2], acts_tm[r, b])


# ---------------------------------------------------------------------------
# the build layout
# ---------------------------------------------------------------------------

ENV_UNITS = ["acrobot", "cart_pole", "eesm", "fluid_tank", "induction_machine", "mass_spring_damper", "pendulum",
             "van_der_pol"]


@pytest.mark.parametrize("name", ["stepper", "closed_loop"])
def test_split_libraries_have_one_translation_unit_per_environment(name):
    sources = K.library_sources(name)
    assert sources[0] == K.CSRC / f"{name}.cu"
    assert [p.stem for p in sources[1:]] == ENV_UNITS
    for unit in sources[1:]:
        assert f'#include "../{name}.cuh"' in unit.read_text()
    assert K.library_sources("pmsm_stepper") == [K.CSRC / "pmsm_stepper.cu"]


def test_library_hash_covers_every_source_and_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(K.CSRC, csrc)
    monkeypatch.setattr(K, "CSRC", csrc)
    base = {name: K._library_path(name) for name in ("stepper", "closed_loop", "pmsm_fast")}
    assert len(set(base.values())) == 3
    touched = [csrc / "closed_loop.cu", csrc / "closed_loop" / "eesm.cu", csrc / "classic_envs.cuh"]
    for path in touched:
        original = path.read_text()
        path.write_text(original + "\n// changed\n")
        assert K._library_path("closed_loop") != base["closed_loop"], path.name
        path.write_text(original)
        assert K._library_path("closed_loop") == base["closed_loop"]
    # a unit of another library, or a file that is no source, leaves it alone
    (csrc / "stepper" / "eesm.cu").write_text("// changed\n")
    (csrc / "closed_loop" / "notes.txt").write_text("not a source\n")
    assert K._library_path("closed_loop") == base["closed_loop"]
    assert K._library_path("stepper") != base["stepper"]
    # a new translation unit joins its library's hash
    (csrc / "closed_loop" / "extra.cu").write_text("// a new unit\n")
    assert K._library_path("closed_loop") != base["closed_loop"]
    monkeypatch.setattr(K, "NVCC_FLAGS", K.NVCC_FLAGS + ("-lineinfo",))
    assert K._library_path("pmsm_fast") != base["pmsm_fast"]
