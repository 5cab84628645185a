"""What the two fast-math kernels (``csrc/pendulum_fast.cu``,
``csrc/pmsm_fast.cu``) and their wrappers rely on, held on the CPU.

* The action ring (``csrc/action_ring.cuh``, shared with ``stepper.cu``),
  mirrored in numpy with the fast pendulum's schedule (tiles issued
  ``stages - 1`` ahead, full tiles read whole, the last one ragged), in the
  fast pendulum's geometry (128-byte tiles, two stages) and the stepper's
  (64-byte tiles, three stages; one, two and the EESM's three actions):
  every instance reads exactly the time-major slab's value at every step,
  from either layout, in 16-byte or element-wise pieces, for horizons that
  end inside a tile, rows that are no 16-byte multiples and a ragged
  batch; the geometry of the existing rings is unchanged.
* The fast PMSM kernel's row pointer (one action pair per load, one row
  ahead) visits the time-major slab's pairs in either layout.
* The entry points hand a contiguous slab of either layout to the kernel
  without a copy (``_slab_layout``).
* The fast PMSM wrapper's packed arguments: the rotation pairs, the
  interleaved table, the leaves' strides, the folded advance; the kernel's
  placement of the table in shared memory (every channel of every point
  read back, the loads spread over all banks).
* The kernel's start and final angle, written in the kernel's order,
  equal ``fast_start``/``fast_final_angle`` bit for bit.

The kernels themselves run only on a CUDA card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phases 13 and 14).
"""

import math

import numpy as np
import pytest
import torch

import exciting_environments_torch as P
from exciting_environments_torch.ops import pmsm_fast as PF
from exciting_environments_torch.ops.fastmath import wrap_angle_fast
from exciting_environments_torch.ops.kernels import pendulum_fast as PFK
from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PMK
from exciting_environments_torch.ops.lut import interleave_channels
from exciting_environments_torch.ops.transforms import ROTATION_IM, ROTATION_RE

DTYPES = [torch.float32, torch.float64]

# ---------------------------------------------------------------------------
# the action ring, mirrored
# ---------------------------------------------------------------------------

THREADS = 128
#: (tile bytes, stages) of csrc/pendulum_fast.cu and csrc/stepper.cu
PENDULUM_FAST_RING, STEPPER_RING = (128, 2), (64, 3)


def ring_geometry(n_action, itemsize, tile_bytes):
    """action_ring.cuh's Ring: rows per tile K (rounded down so that K * A
    values are whole 16-byte pieces), K * A, the batch-major row padding (one
    16-byte piece, two where one would put neighbouring rows 32 words apart)
    and the slot size, in elements."""
    row = n_action * itemsize
    unit = 16 // math.gcd(16, row)
    k = tile_bytes // row // unit * unit
    p16 = 16 // itemsize
    pad = 2 * p16 if ((k * n_action + p16) * itemsize // 4) % 8 == 0 else p16
    return k, k * n_action, pad, THREADS * (k * n_action + pad)


def element_piece(n_action, itemsize):
    """Ring::E1: the action vector where cp.async copies its size, else one
    value."""
    return n_action if n_action * itemsize in (4, 8, 16) else 1


def tile_copy(tid, e, b0, batch, n_rows, n_action, itemsize, tile_bytes, batch_major):
    """action_ring.cuh::tile_copy for thread ``tid``."""
    k, ka, pad, _ = ring_geometry(n_action, itemsize, tile_bytes)
    lines = THREADS if batch_major else k
    ppl = (ka if batch_major else THREADS * n_action) // e
    c = {"e": e, "lines": lines, "ppl": ppl, "line0": tid // ppl, "pos0": tid % ppl, "dl": THREADS // ppl,
         "dp": THREADS % ppl, "n": -(-lines * ppl // THREADS)}
    if batch_major:
        c.update(src=b0 * n_rows * n_action, src_line=n_rows * n_action, src_tile=ka, dst_line=ka + pad)
    else:
        c.update(src=b0 * n_action, src_line=batch * n_action, src_tile=k * batch * n_action,
                 dst_line=THREADS * n_action)
    return c


def issue_tile(slot, slab, c, e, tile, b0, batch, n_rows, n_action, itemsize, tile_bytes, batch_major):
    """action_ring.cuh::issue_tile for one thread: its pieces of ``e``
    elements, zero-filled past the batch or the horizon (where the action
    vector is a copy size, the kernel steps a pointer over the same
    pieces)."""
    k = ring_geometry(n_action, itemsize, tile_bytes)[0]
    row0 = tile * k
    lines = batch - b0 if batch_major else n_rows - row0
    line_elems = (n_rows - row0) * n_action if batch_major else (batch - b0) * n_action
    src = c["src"] + tile * c["src_tile"]
    line, pos = c["line0"], c["pos0"]
    for _ in range(c["n"]):
        if line < c["lines"]:
            el = pos * e
            ok = line < lines and el < line_elems
            dst = line * c["dst_line"] + el
            at = src + line * c["src_line"] + el
            slot[dst : dst + e] = slab[at : at + e] if ok else 0
        line, pos = line + c["dl"], pos + c["dp"]
        if pos >= c["ppl"]:
            line, pos = line + 1, pos - c["ppl"]


def ring_reads(slab, batch, n_rows, n_action, itemsize, batch_major, ring=PENDULUM_FAST_RING, base_address=0):
    """The actions each instance of each block reads at each row, through the
    ring as csrc/pendulum_fast.cu runs it with ``ring = (tile bytes,
    stages)``: ``(n_rows, batch, n_action)``."""
    tile_bytes, stages = ring
    k, ka, pad, size = ring_geometry(n_action, itemsize, tile_bytes)
    n_tiles = -(-n_rows // k)
    line_elems = n_rows * n_action if batch_major else batch * n_action
    vec16 = base_address % 16 == 0 and (line_elems * itemsize) % 16 == 0  # action_ring.cuh::ring_vec16
    e = 16 // itemsize if vec16 else element_piece(n_action, itemsize)
    out = np.full((n_rows, batch, n_action), np.nan)
    for b0 in range(0, batch, THREADS):
        shared = np.full(stages * size, np.nan)
        copies = [tile_copy(t, e, b0, batch, n_rows, n_action, itemsize, tile_bytes, batch_major)
                  for t in range(THREADS)]

        def issue(tile):
            if tile < n_tiles:
                slot = shared[(tile % stages) * size : (tile % stages + 1) * size]
                for c in copies:
                    issue_tile(slot, slab, c, e, tile, b0, batch, n_rows, n_action, itemsize, tile_bytes, batch_major)

        for tile in range(stages - 1):
            issue(tile)
        for tile in range(n_tiles):
            if tile < n_rows // k:  # a full tile issues the one stages - 1 ahead before its rows
                issue(tile + stages - 1)
            base = (tile % stages) * size
            for tid in range(min(THREADS, batch - b0)):
                col = tid * (ka + pad) if batch_major else tid * n_action
                row_step = n_action if batch_major else THREADS * n_action
                for r in range(min(k, n_rows - tile * k)):
                    at = base + col + r * row_step
                    out[tile * k + r, b0 + tid] = shared[at : at + n_action]
    return out


RING_SHAPES = [(256, 64), (300, 99), (256, 100), (1000, 7)]


@pytest.mark.parametrize("batch_major", [False, True], ids=["time_major", "batch_major"])
@pytest.mark.parametrize("batch,n_rows", RING_SHAPES, ids=[f"B{b}_T{t}" for b, t in RING_SHAPES])
@pytest.mark.parametrize("n_action,dtype,ring", [(1, torch.float32, PENDULUM_FAST_RING),
                                                  (2, torch.float64, STEPPER_RING),
                                                  (3, torch.float32, STEPPER_RING),
                                                  (3, torch.float64, STEPPER_RING)],
                         ids=["pendulum_fast_A1_f32", "stepper_A2_f64", "stepper_A3_f32", "stepper_A3_f64"])
def test_action_ring_reads_every_action_once_in_either_layout(batch_major, batch, n_rows, n_action, dtype, ring):
    itemsize = torch.empty((), dtype=dtype).element_size()
    acts_tm = np.arange(1, n_rows * batch * n_action + 1, dtype=np.float64).reshape(n_rows, batch, n_action)
    slab = np.ascontiguousarray(acts_tm.transpose(1, 0, 2) if batch_major else acts_tm).reshape(-1)
    got = ring_reads(slab, batch, n_rows, n_action, itemsize, batch_major, ring)
    np.testing.assert_array_equal(got, acts_tm)


def test_action_ring_geometry_of_each_slab():
    """Rows per tile and padding: the pendulum's and the two-action rings
    as before the three-action ring came (16, 8, 8 and 4 rows of 64 bytes,
    32 of 128), the three-action rows rounded to whole 16-byte lines, and
    no padding that puts neighbouring batch-major rows on one bank."""
    assert ring_geometry(1, 4, 64)[:3] == (16, 16, 4) and ring_geometry(1, 4, 128)[:3] == (32, 32, 4)
    assert ring_geometry(2, 4, 64)[:3] == (8, 16, 4) and ring_geometry(1, 8, 64)[:3] == (8, 8, 2)
    assert ring_geometry(2, 8, 64)[:3] == (4, 8, 2)
    assert ring_geometry(3, 4, 64)[:3] == (4, 12, 8) and ring_geometry(3, 8, 64)[:3] == (2, 6, 4)
    for a, item in ((1, 4), (2, 4), (3, 4), (1, 8), (2, 8), (3, 8)):
        _, ka, pad, _ = ring_geometry(a, item, 64)
        assert (ka * item) % 16 == 0 and ((ka + pad) * item // 4) % 8 != 0
    assert [element_piece(a, 4) for a in (1, 2, 3)] == [1, 2, 1] and element_piece(3, 8) == 1


@pytest.mark.parametrize("batch_major", [False, True], ids=["time_major", "batch_major"])
def test_action_ring_element_pieces_on_a_misaligned_slab(batch_major):
    """A slab whose base is no 16-byte multiple is copied element-wise."""
    batch, n_rows = 256, 64
    acts_tm = np.arange(1, n_rows * batch + 1, dtype=np.float64).reshape(n_rows, batch, 1)
    slab = np.ascontiguousarray(acts_tm.transpose(1, 0, 2) if batch_major else acts_tm).reshape(-1)
    got = ring_reads(slab, batch, n_rows, 1, 4, batch_major, base_address=4)
    np.testing.assert_array_equal(got, acts_tm)


# ---------------------------------------------------------------------------
# the fast PMSM kernel's row pointer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_major", [False, True], ids=["time_major", "batch_major"])
@pytest.mark.parametrize("batch,n_steps", [(5, 7), (3, 1), (4, 2)])
def test_pmsm_fast_action_pairs_are_read_in_place(batch_major, batch, n_steps):
    """csrc/pmsm_fast.cu's action pairs: the first pair at b * T (batch-major)
    or b (time-major), one load ahead of its step, then one row stride (1 or
    B pairs) per step."""
    acts_tm = torch.arange(n_steps * batch * 2, dtype=torch.float64).reshape(n_steps, batch, 2)
    pairs = (acts_tm.transpose(0, 1) if batch_major else acts_tm).contiguous().reshape(-1, 2)
    row_stride = 1 if batch_major else batch
    for b in range(batch):
        at = b * n_steps if batch_major else b
        a_next = pairs[at]
        for t in range(n_steps):
            a = a_next
            if t + 1 < n_steps:
                at += row_stride
                a_next = pairs[at]
            assert torch.equal(a, acts_tm[t, b])


# ---------------------------------------------------------------------------
# the slab handed to the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("time_major", [False, True], ids=["batch_major", "time_major"])
def test_pendulum_fast_hands_a_contiguous_slab_over_in_place(time_major):
    B, T = 64, 40
    acts = torch.rand((T, B, 1) if time_major else (B, T, 1))
    slab, batch_major = PFK.kernel_slab(acts, time_major)
    assert slab.data_ptr() == acts.data_ptr() and batch_major == (not time_major)
    assert slab.is_contiguous() and tuple(slab.shape) == ((T, B) if time_major else (B, T))
    # contiguous in neither layout: one copy, read batch-major
    strided = torch.rand((B, 2 * T, 1))[:, ::2]
    slab, batch_major = PFK.kernel_slab(strided, False)
    assert slab.data_ptr() != strided.data_ptr() and slab.is_contiguous() and batch_major
    assert torch.equal(slab, strided[..., 0])


@pytest.mark.parametrize("time_major", [False, True], ids=["batch_major", "time_major"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pmsm_fast_hands_a_contiguous_slab_over_in_place(time_major, dtype):
    env = P.PMSM(batch_size=16, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu", dtype=dtype)
    _, state = env.vmap_reset()
    acts = torch.rand((5, 16, 2) if time_major else (16, 5, 2), dtype=dtype)
    _, actions_tm, _ = PF.fast_inputs(env, state, acts, time_major)
    slab, batch_major = PMK.kernel_slab(actions_tm)
    assert slab.data_ptr() == acts.data_ptr() and batch_major == (not time_major)
    # a view whose pairs are not 8- or 16-byte aligned is copied, aligned
    flat = torch.zeros(16 * 5 * 2 + 1, dtype=dtype)
    misaligned = flat[1:].view(16, 5, 2)
    misaligned.copy_(acts if not time_major else acts.transpose(0, 1))
    _, actions_tm, _ = PF.fast_inputs(env, state, misaligned, False)
    slab, batch_major = PMK.kernel_slab(actions_tm)
    assert slab.data_ptr() % (2 * slab.element_size()) == 0 and batch_major
    assert torch.equal(slab, misaligned)


# ---------------------------------------------------------------------------
# the fast PMSM wrapper's packed arguments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_pmsm_fast_packed_arguments(dtype):
    B, T = 16, 5
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu", dtype=dtype)
    _, state = env.vmap_reset()
    with P.core.structures.copy_and_mutate(state) as state:
        state.physical_state.omega_el = torch.tensor(1200.0, dtype=dtype)  # a broadcast scalar
    acts = torch.rand((B, T, 2), dtype=dtype)
    consts, actions_tm, leaves = PF.fast_inputs(env, state, acts, False)
    slab, batch_major = PMK.kernel_slab(actions_tm)
    args, out, keep = PMK.pack_args(env, slab, leaves, consts, batch_major)
    # the rotations: ROTATION_RE/IM at b0 * 4 + b1 * 2 + b2, in the working type
    assert list(args.rot_re) == [float(v) for v in ROTATION_RE.reshape(-1)]
    assert list(args.rot_im) == [float(v) for v in ROTATION_IM.reshape(-1)]
    # the kernel converts each to the working type once, as the plain
    # version's table lookup (hex_clip_fast) converts its entries
    for packed, table in ((args.rot_re, ROTATION_RE), (args.rot_im, ROTATION_IM)):
        in_kernel = torch.tensor(list(packed), dtype=torch.float64).to(dtype)
        assert torch.equal(in_kernel, torch.as_tensor(table.reshape(-1)).to(dtype))
    # the interleaved table (the kernel sizes its shared memory from nx and
    # ny: tests/test_torch_gpu.py holds that size against the source note)
    table = env._lut.interleaved()
    assert args.lut == table.data_ptr() and torch.equal(table, interleave_channels(env._lut.values))
    assert (args.nx, args.ny) == (env._lut.nx, env._lut.ny) and env._lut.nx * env._lut.ny == 1484
    # the leaves in place: a broadcast scalar has stride 0
    assert [args.leaf[j] for j in range(6)] == [leaves[n].data_ptr() for n in PMK.LEAVES]
    assert list(args.leaf_stride) == [0 if n == "omega_el" else 1 for n in PMK.LEAVES]
    assert args.actions == acts.data_ptr() and args.batch_major == 1 and args.n_steps == T and args.batch == B
    assert args.adv_scale == (consts["deadtime"] + 0.5) * consts["tau"] and args.deadtime == 1
    assert len(out) == 6 and all(o.shape == (B,) and o.dtype == dtype for o in out)
    linear = P.PMSM(batch_size=B, motor_variant=P.MotorVariant.DEFAULT, device="cpu", dtype=dtype)
    _, lstate = linear.vmap_reset()
    consts, actions_tm, leaves = PF.fast_inputs(linear, lstate, acts, False)
    largs, _, _ = PMK.pack_args(linear, PMK.kernel_slab(actions_tm)[0], leaves, consts, True)
    assert not largs.lut and (largs.nx, largs.ny, largs.saturated) == (0, 0, 0)


def test_pmsm_fast_wrapper_refuses_what_the_kernel_does_not_take():
    env = P.PMSM(batch_size=16, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu",
                 dtype=torch.float32)
    _, state = env.vmap_reset()
    consts, actions_tm, leaves = PF.fast_inputs(env, state, torch.zeros((16, 4, 2)), False)
    with pytest.raises(ValueError, match="contiguous slab"):
        PMK.pack_args(env, actions_tm, leaves, consts, False)  # a transposed view
    with pytest.raises(ValueError, match="actions"):
        PMK.pack_args(env, torch.zeros((4, 15, 2)), leaves, consts, False)
    with pytest.raises(ValueError, match="CUDA"):
        PMK.kernel_pmsm_fast_rollout(env, torch.zeros((4, 16, 2)), leaves, consts)


# ---------------------------------------------------------------------------
# the fast PMSM kernel's table in shared memory, mirrored
# ---------------------------------------------------------------------------


def placed_slots(p):
    """csrc/pmsm_fast.cu's placement of grid point ``p``: (the element offset
    of its quad, channels 0-3, and of its pair, channels 4-5, in the point)."""
    slot = (p >> 2) & 3
    return (1 - (slot >> 1)) * 4, slot * 2


def placed_table(interleaved):
    """The kernel's copy-in: each point's quad and pair from the interleaved
    ``(nx, ny, 8)`` table to its placed offsets (unwritten elements NaN)."""
    flat = interleaved.reshape(-1, 8).numpy()
    out = np.full_like(flat, np.nan)
    for p, row in enumerate(flat):
        quad, pair = placed_slots(p)
        out[p, quad:quad + 4] = row[:4]
        out[p, pair:pair + 2] = row[4:6]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_pmsm_fast_placed_table_holds_every_channel_of_every_point(dtype):
    """load_point's addressing reads back each point's six channels of the
    stacked table from the placed one, and the quad and pair never overlap."""
    env = P.PMSM(batch_size=4, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu", dtype=dtype)
    lut = env._lut
    placed = placed_table(lut.interleaved())
    stacked = lut.values.reshape(6, -1).numpy()
    for p in range(lut.nx * lut.ny):
        quad, pair = placed_slots(p)
        assert quad + 4 <= pair or pair + 2 <= quad
        got = np.concatenate([placed[p, quad:quad + 4], placed[p, pair:pair + 2]])
        assert np.array_equal(got, stacked[:, p])


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("first", [0, 5, 1471])
def test_pmsm_fast_placed_points_spread_over_the_banks(itemsize, first):
    """Sixteen consecutive points' quads and pairs (the loads of a warp that
    gathers at spread points) fall evenly on the 32 four-byte banks, where
    fixed offsets in 32- or 64-byte points would leave banks idle."""
    points = np.arange(first, first + 16)
    for load, width in ((0, 4), (1, 2)):  # the quad, the pair
        words = np.concatenate([(p * 8 + placed_slots(p)[load] + np.arange(width)) * itemsize // 4 + k
                                for p in points for k in range(itemsize // 4)])
        counts = np.bincount(words % 32, minlength=32)
        assert counts.min() == counts.max(), counts
        fixed = np.concatenate([(p * 8 + 4 * load + np.arange(width)) * itemsize // 4 + k
                                for p in points for k in range(itemsize // 4)])
        assert np.bincount(fixed % 32, minlength=32).min() == 0


# ---------------------------------------------------------------------------
# the kernel's start and end
# ---------------------------------------------------------------------------


def kernel_start(eps, omega, args):
    """csrc/pmsm_fast.cu::fast_start in its order: each Python number rounded
    to the working type where it meets a tensor."""
    dt = eps.dtype
    delta = omega * torch.tensor(args.tau, dtype=dt)
    adv0 = eps + omega * torch.tensor(args.adv_scale, dtype=dt)
    return torch.cos(adv0), torch.sin(adv0), torch.cos(delta), torch.sin(delta)


def kernel_final_angle(eps, omega, args):
    """csrc/pmsm_fast.cu::fast_final_angle in its order."""
    dt = eps.dtype
    return wrap_angle_fast(eps + (omega * torch.tensor(args.tau, dtype=dt)) * torch.tensor(float(args.n_steps),
                                                                                              dtype=dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("deadtime", [0, 1])
@pytest.mark.parametrize("span", [math.pi, 1e3], ids=["wrapped", "wide"])
def test_kernel_start_and_final_angle_equal_the_eager_ones(dtype, deadtime, span):
    B, T = 4096, 256
    static = dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=deadtime,
                  l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=static,
                 tau=1e-4, device="cpu", dtype=dtype)
    rng = np.random.default_rng(11 + deadtime)
    _, state = env.vmap_reset()
    with P.core.structures.copy_and_mutate(state) as state:
        state.physical_state.epsilon = torch.as_tensor(rng.uniform(-span, span, B), dtype=dtype)
        state.physical_state.omega_el = torch.as_tensor(
            rng.uniform(-1, 1, B) * env.env_properties.physical_normalizations.omega_el.max, dtype=dtype)
    consts, actions_tm, leaves = PF.fast_inputs(env, state, torch.zeros((B, T, 2), dtype=dtype), False)
    args, _, _ = PMK.pack_args(env, PMK.kernel_slab(actions_tm)[0], leaves, consts, True)
    eps, omega = leaves["epsilon"], leaves["omega_el"]
    for got, want in zip(kernel_start(eps, omega, args), PF.fast_start(eps, omega, consts)):
        assert torch.equal(got, want)
    assert torch.equal(kernel_final_angle(eps, omega, args), PF.fast_final_angle(eps, omega, consts, T))
