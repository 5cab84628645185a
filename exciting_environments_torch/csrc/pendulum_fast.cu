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
//
// What the design does about it: one thread per pendulum holds its state in
// registers for the whole horizon, so no time-chunk grid and no state
// round trip through device memory are needed; the time-major (T, B) slab is
// read coalesced (neighbouring threads, neighbouring addresses).  The TPU
// kernel's (rows, 128) tiles, its time-chunk grid with the state revisited in
// VMEM and its batch % 128 and T % chunk conditions have no counterpart: any
// B and any T run, and the ragged edge of the batch is masked.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/pendulum_fast.py::plain_pendulum_fast_rollout) in order and in
// float32, built with --fmad=false (fastmath.cuh, eager_rules.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "fastmath.cuh"

// Mirrored field for field by PendulumFastArgs in ops/kernels/pendulum_fast.py.
struct PendulumFastArgs {
    double tau;
    double c_grav;    // l * m * g
    double inv_ml2;   // 1 / (m * l ** 2)
    double a_scale;   // (max - min) / 2 of the torque normalization
    double a_offset;  // (max + min) / 2
    const void* actions;  // normalized, (T, B) float32
    const void* theta0;   // (B,)
    const void* omega0;   // (B,)
    void* theta_out;      // (B,)
    void* omega_out;      // (B,)
    long long batch;
    int n_steps;
};

__global__ void __launch_bounds__(128) pendulum_fast_kernel(const __grid_constant__ PendulumFastArgs args) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const long long batch = args.batch;
    const float tau = (float)args.tau;
    const float c_grav = (float)args.c_grav;
    const float inv_ml2 = (float)args.inv_ml2;
    const float a_scale = (float)args.a_scale;
    const float a_offset = (float)args.a_offset;
    const float* __restrict__ a = static_cast<const float*>(args.actions);

    float th = static_cast<const float*>(args.theta0)[b];
    float om = static_cast<const float*>(args.omega0)[b];
    for (int t = 0; t < args.n_steps; ++t) {
        const float u = a[(long long)t * batch + b] * a_scale + a_offset;
        const float d_om = (u + c_grav * poly_sin(th)) * inv_ml2;
        const float th1 = wrap_angle_fast(th + tau * om);
        om = om + tau * d_om;
        th = th1;
    }
    static_cast<float*>(args.theta_out)[b] = th;
    static_cast<float*>(args.omega_out)[b] = om;
}

static constexpr int THREADS = 128;

extern "C" int pendulum_fast_args_size() { return (int)sizeof(PendulumFastArgs); }

// dtype: 0 float32 (the only type).  Returns cudaGetLastError() after the launch.
extern "C" int pendulum_fast_launch(const PendulumFastArgs* args, int dtype, void* stream) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    if (args->batch <= 0) return 0;
    const unsigned blocks = (unsigned)((args->batch + THREADS - 1) / THREADS);
    pendulum_fast_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
    return (int)cudaGetLastError();
}
