// Speed-of-light pendulum rollout: fast-math Euler steps of a pendulum fleet
// with scalar parameters over a whole horizon in one launch, float32.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pendulum_fast.py::
// _pendulum_kernel_call.  Per step, with the constants folded in double on
// the host (c_grav = l m g, inv_ml2 = 1 / (m l^2), the action's scale and
// offset):
//   u     = a * a_scale + a_offset
//   d_om  = (u + c_grav * poly_sin(th)) * inv_ml2
//   th    = wrap_angle_fast(th + tau * om)
//   om    = om + tau * d_om
// poly_sin gets th without a wrap of its own (th is wrapped after every
// step), and the update multiplies by inv_ml2 where the exact pendulum
// divides.
//
// What bounds it on an H100: the action slab.  Each pendulum reads T floats
// once and keeps (th, om) in registers; at the main size (B = 65,536,
// T = 4,096) the slab is 1.07 GB, 0.32 ms at 3.35 TB/s, against 30 float32
// operations per step and pendulum (8.1e9 in all, 0.12 ms at 67 TFLOP/s).
// The issue time of the step's ~35 SASS instructions at 15.5 warps per SM
// is about as long (~0.29 ms), so the kernel can come near its byte bound
// only while no step waits on device memory.  The first version of this
// kernel read one dependent 4-byte load per step: about 2 KB in flight per
// SM, where 3.35 TB/s needs some 25 KB, and it ran at 46-49% of the bound.
//
// What the design does about it: one thread per pendulum holds (th, om) in
// registers for the whole horizon, and the block stages its 128 pendulums'
// actions through the action ring of action_ring.cuh (shared with
// stepper.cu): two shared-memory tiles of 32 rows (36,864 B per block),
// the next one filled with cp.async while the rows of the current one are
// integrated, 16 KB per block and some 60 KB per SM in flight.  A tile is
// copied in 16-byte pieces where the slab's lines allow it (else one action
// per piece), the ragged edges zero-filled, from either layout in place:
// time-major (T, B) or batch-major (B, T), so a batch-major slab needs no
// transposed copy.  The tile is 128 bytes of each pendulum's actions: a
// batch-major slab is then read in whole 128-byte lines per pendulum (with
// the 64-byte tiles of stepper.cu the batch-major read was a third slower
// than the time-major one on an H100; of tiles of 32-256 bytes and 2-4
// stages, 128 bytes and two stages read both layouts fastest).  A full
// tile's 32 steps are unrolled (no per-row loop counter); the last, ragged
// tile runs a row loop.  The TPU kernel's (rows, 128) tiles, its time-chunk
// grid with the state revisited in VMEM and its batch % 128 and T % chunk
// conditions have no counterpart: any B and any T run.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/pendulum_fast.py::plain_pendulum_fast_rollout) in order and in
// float32, built with --fmad=false (fastmath.cuh, eager_rules.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "action_ring.cuh"
#include "eager_rules.cuh"
#include "fastmath.cuh"

// Mirrored field for field by PendulumFastArgs in ops/kernels/pendulum_fast.py.
struct PendulumFastArgs {
    double tau;
    double c_grav;    // l * m * g
    double inv_ml2;   // 1 / (m * l ** 2)
    double a_scale;   // (max - min) / 2 of the torque normalization
    double a_offset;  // (max + min) / 2
    const void* actions;  // normalized, (T, B) float32, or (B, T) with batch_major
    const void* theta0;   // (B,)
    const void* omega0;   // (B,)
    void* theta_out;      // (B,)
    void* omega_out;      // (B,)
    long long batch;
    int n_steps;
    int batch_major;      // layout of the action slab
};

static constexpr int THREADS = 128;     // pendulums per block
static constexpr int STAGES = 2;        // tiles in the ring: the one being read and the one in flight
static constexpr int TILE_BYTES = 128;  // bytes of one pendulum's actions per tile (32 rows)
using R = Ring<float, 1, THREADS, TILE_BYTES>;

__global__ void __launch_bounds__(THREADS) pendulum_fast_kernel(const __grid_constant__ PendulumFastArgs args) {
    __shared__ __align__(16) float ring[STAGES * R::SLOT];

    const long long batch = args.batch;
    const long long b0 = (long long)blockIdx.x * THREADS;
    const long long b = b0 + threadIdx.x;
    const bool active = b < batch;
    const long long bl = active ? b : batch - 1;  // an idle thread of the ragged block runs a real pendulum
    float tau = (float)args.tau;
    float c_grav = (float)args.c_grav;
    float inv_ml2 = (float)args.inv_ml2;
    float a_scale = (float)args.a_scale;
    float a_offset = (float)args.a_offset;
    keep(tau);
    keep(c_grav);
    keep(inv_ml2);
    keep(a_scale);
    keep(a_offset);

    float th = static_cast<const float*>(args.theta0)[bl];
    float om = static_cast<const float*>(args.omega0)[bl];
    auto step = [&](float a) {
        const float u = a * a_scale + a_offset;
        const float d_om = (u + c_grav * poly_sin(th)) * inv_ml2;
        const float th1 = wrap_angle_fast(th + tau * om);
        om = om + tau * d_om;
        th = th1;
    };

    // the ring: tile 0 in flight before the loop, tile + 1 issued when tile
    // is read
    const float* __restrict__ slab = static_cast<const float*>(args.actions);
    const int n_rows = args.n_steps;
    const int n_tiles = (n_rows + R::K - 1) / R::K;
    const bool batch_major = args.batch_major != 0;
    const bool vec16 = ring_vec16(slab, batch_major ? (long long)n_rows : batch);
    const TileCopy copy = tile_copy<R>(vec16 ? 4 : 1, b0, batch, n_rows, batch_major);
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            float* slot = ring + (tile % STAGES) * R::SLOT;
            if (vec16)
                issue_tile<R, 16>(slot, slab, copy, tile, b0, batch, n_rows, batch_major);
            else
                issue_tile<R, 4>(slot, slab, copy, tile, b0, batch, n_rows, batch_major);
        }
        cp_async_commit();
    };
#pragma unroll 1
    for (int tile = 0; tile < STAGES - 1; ++tile) issue(tile);
    // this thread's column of a slot: row r at col + r * row_step
    const int col = batch_major ? threadIdx.x * (R::KA + R::PAD) : threadIdx.x;
    const int row_step = batch_major ? 1 : THREADS;

    const int n_full = n_rows / R::K;
    int tile = 0;
#pragma unroll 1
    for (; tile < n_full; ++tile) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        issue(tile + STAGES - 1);  // into the slot of tile - 1, which every thread has finished
        const float* cur = ring + (tile % STAGES) * R::SLOT + col;
#pragma unroll
        for (int r = 0; r < R::K; ++r) step(cur[r * row_step]);
    }
    if (tile < n_tiles) {
        // the last tile, ragged: its group is complete after this wait (no
        // later tile was issued)
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const float* cur = ring + (tile % STAGES) * R::SLOT + col;
        const int rows = n_rows - tile * R::K;
#pragma unroll 1
        for (int r = 0; r < rows; ++r) step(cur[r * row_step]);
    }
    cp_async_wait<0>();
    if (active) {
        static_cast<float*>(args.theta_out)[b] = th;
        static_cast<float*>(args.omega_out)[b] = om;
    }
}

extern "C" int pendulum_fast_args_size() { return (int)sizeof(PendulumFastArgs); }

// dtype: 0 float32 (the only type).  Returns cudaGetLastError() after the launch.
extern "C" int pendulum_fast_launch(const PendulumFastArgs* args, int dtype, void* stream) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    if (args->batch <= 0) return 0;
    const unsigned blocks = (unsigned)((args->batch + THREADS - 1) / THREADS);
    pendulum_fast_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
    return (int)cudaGetLastError();
}
