// Trig-free PMSM drive rollout: the whole drive step (action denormalization,
// inverter hexagon at the carried deadtime-advanced angle, deadtime buffer,
// LUT-gathered or linear Euler step of the currents, rotation carry) for T
// steps in one launch, streaming only the normalized actions.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py::
// _make_kernel (+ _hex_clip_tiles; launcher _fast_core).  Per step, as the
// plain version ops/pmsm_fast.py::plain_pmsm_fast_rollout:
//   u = a * scale + offset, n = u * 2 / u_dc;
//   (alpha, beta) = rotation of n by the carried (cA, sA);
//   the hexagon clip: sector bits from linear sign tests, the sector
//   rotation from the table ops/transforms.py ROTATION_RE/IM at [b0][b1][b2]
//   (passed in the arguments), the clamp to the top sector's rectangle, the
//   rotation back;
//   u_c = rotation back to dq, * u_dc / 2; deadtime 1: the buffer drives the
//   currents and takes u_c;
//   di = L^-1 (u - r_s i - omega J psi) from the six gathered channels
//   (saturated), or the linear ODE; i += tau di;
//   (cA, sA) advanced by (cos, sin)(omega tau), renormalized to first order.
// After the loop, the torque from one more gather at the final currents.
// The wrapper computes the carry's start, the rotation constants and the
// final angle with the plain version's eager operations, so that both start
// from the same tensors.
//
// What bounds it on an H100: at the main size (saturated BRUSA, B = 65,536,
// T = 256, float32) the normalized action slab is 134 MB, 0.040 ms at
// 3.35 TB/s, and the step is about 160 float32 operations per drive (2.7e9
// in all, 0.041 ms at 67 TFLOP/s): the two bounds tie.  In practice the 24
// data-dependent shared-memory loads of each step's gather and the chain of
// dependent operations set the time, as in pmsm_stepper.cu.
//
// What the design does about it: one thread per drive keeps its six state
// values (i_d, i_q, cA, sA, buf_d, buf_q), omega and the rotation constants
// in registers for all T steps; no per-step transcendental is left.  The
// magnetics table sits in dynamic shared memory (35,616 B for BRUSA in
// float32; 71,232 B in float64, above 48 KB after cudaFuncSetAttribute), with
// the gather of pmsm_drive.cuh (0.0 against ops/lut.py::bilinear_gather).
// The (T, B, 2) slab is read time-major, coalesced.  The TPU kernel's
// one-hot gather encodings (int8x4, bf16x3), its 2 MB chunk budget, its
// (8, 128) tiles and batch % 1024 have no counterpart: any B runs, float32
// and float64.
//
// Exactness: every operation mirrors the plain version in order and in the
// working precision, built with --fmad=false (eager_rules.cuh): the
// constants arrive folded in double as Python folds them, the divisions by
// the inductance determinant are true divisions, the clamps compare.

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "pmsm_drive.cuh"

// Mirrored field for field by PmsmFastArgs in ops/kernels/pmsm_fast_kernel.py.
struct PmsmFastArgs {
    double tau;
    double p15;                         // 1.5 * p
    double r_s;
    double l_d, l_q, psi_p;             // linear magnetics
    double dl;                          // l_d - l_q
    double inv_ld, inv_lq;              // 1 / l_d, 1 / l_q
    double a_scale_d, a_off_d, a_scale_q, a_off_q;
    double to_halfdc, from_halfdc;      // 2 / u_dc, u_dc / 2
    double x0, dx, y0, dy;              // LUT grid (Python numbers)
    double rot_re[8], rot_im[8];        // ops/transforms.py ROTATION_RE/IM at [b0][b1][b2]
    const void* lut;                    // (6, nx, ny), saturated only
    const void* actions;                // normalized, (T, B, 2)
    const void* state0[6];              // (B,) i_d, i_q, cA, sA, u_d_buffer, u_q_buffer
    const void* omega;                  // (B,)
    const void* c_delta;                // (B,) cos(omega tau)
    const void* s_delta;                // (B,) sin(omega tau)
    void* out[5];                       // (B,) i_d, i_q, u_d_buffer, u_q_buffer, torque
    long long batch;
    int nx, ny;
    int n_steps;
    int saturated;
    int deadtime;                       // 0 or 1
};

// ops/pmsm_fast.py::hex_clip_fast
template <typename T>
__device__ __forceinline__ void hex_clip_fast(const PmsmFastArgs& args, T& alpha, T& beta) {
    const T s120 = (T)0.8660254037844386;
    const int b0 = beta >= T(0);
    const int b1 = (T)-0.5 * beta - s120 * alpha >= T(0);
    const int b2 = (T)-0.5 * beta + s120 * alpha >= T(0);
    const int idx = b0 * 4 + b1 * 2 + b2;
    const T rot_re = (T)args.rot_re[idx], rot_im = (T)args.rot_im[idx];
    T ra = alpha * rot_re - beta * rot_im;
    T rb = alpha * rot_im + beta * rot_re;
    ra = clampv(ra, (T)(-2.0 / 3.0), (T)(2.0 / 3.0));
    rb = clampv(rb, T(0), (T)(2.0 / 3.0 * 1.7320508075688772));
    alpha = ra * rot_re + rb * rot_im;
    beta = rb * rot_re - ra * rot_im;
}

template <typename T, bool SAT, int DEADTIME>
__global__ void __launch_bounds__(128) pmsm_fast_kernel(const __grid_constant__ PmsmFastArgs args) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* lut = reinterpret_cast<T*>(smem_raw);
    if (SAT) {
        // every thread of the block takes part before any returns
        const int n = N_CHANNELS * args.nx * args.ny;
        const T* src = static_cast<const T*>(args.lut);
        for (int i = threadIdx.x; i < n; i += blockDim.x) lut[i] = src[i];
        __syncthreads();
    }
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const long long batch = args.batch;

    // the table's grid, for the gather of pmsm_drive.cuh
    Drive<T> grid;
    grid.x0 = (T)args.x0;
    grid.y0 = (T)args.y0;
    grid.dx = divisor(weak_const<T>(args.dx));
    grid.dy = divisor(weak_const<T>(args.dy));
    grid.nx = args.nx;
    grid.ny = args.ny;

    const T tau = (T)args.tau, r_s = (T)args.r_s;
    const T l_d = (T)args.l_d, l_q = (T)args.l_q, psi_p = (T)args.psi_p;
    const T inv_ld = (T)args.inv_ld, inv_lq = (T)args.inv_lq;
    const T a_scale_d = (T)args.a_scale_d, a_off_d = (T)args.a_off_d;
    const T a_scale_q = (T)args.a_scale_q, a_off_q = (T)args.a_off_q;
    const T to_halfdc = (T)args.to_halfdc, from_halfdc = (T)args.from_halfdc;
    const T omega = static_cast<const T*>(args.omega)[b];
    const T c_delta = static_cast<const T*>(args.c_delta)[b];
    const T s_delta = static_cast<const T*>(args.s_delta)[b];
    T i_d = static_cast<const T*>(args.state0[0])[b];
    T i_q = static_cast<const T*>(args.state0[1])[b];
    T cA = static_cast<const T*>(args.state0[2])[b];
    T sA = static_cast<const T*>(args.state0[3])[b];
    T buf_d = static_cast<const T*>(args.state0[4])[b];
    T buf_q = static_cast<const T*>(args.state0[5])[b];
    const T* __restrict__ act = static_cast<const T*>(args.actions);

    for (int t = 0; t < args.n_steps; ++t) {
        const long long i = ((long long)t * batch + b) * 2;
        const T u_d = act[i] * a_scale_d + a_off_d;
        const T u_q = act[i + 1] * a_scale_q + a_off_q;
        const T nd = u_d * to_halfdc;
        const T nq = u_q * to_halfdc;
        T alpha = cA * nd - sA * nq;
        T beta = sA * nd + cA * nq;
        hex_clip_fast(args, alpha, beta);
        const T ud_c = (cA * alpha + sA * beta) * from_halfdc;
        const T uq_c = (-sA * alpha + cA * beta) * from_halfdc;
        T u_app_d = ud_c, u_app_q = uq_c;
        if (DEADTIME > 0) {
            u_app_d = buf_d;
            u_app_q = buf_q;
            buf_d = ud_c;
            buf_q = uq_c;
        }
        T di_d, di_q;
        if (SAT) {
            T v[N_CHANNELS];
            gather(lut, grid, i_d, i_q, v);
            const T det = v[0] * v[3] - v[1] * v[2];
            const T rhs_d = u_app_d - r_s * i_d + omega * v[5];
            const T rhs_q = u_app_q - r_s * i_q - omega * v[4];
            di_d = (v[3] * rhs_d - v[1] * rhs_q) / det;
            di_q = (v[0] * rhs_q - v[2] * rhs_d) / det;
        } else {
            di_d = (u_app_d + omega * l_q * i_q - r_s * i_d) * inv_ld;
            di_q = (u_app_q - omega * (l_d * i_d + psi_p) - r_s * i_q) * inv_lq;
        }
        i_d = i_d + tau * di_d;
        i_q = i_q + tau * di_q;
        const T c1 = cA * c_delta - sA * s_delta;
        const T s1 = sA * c_delta + cA * s_delta;
        const T r2 = c1 * c1 + s1 * s1;
        const T corr = (T)0.5 * ((T)3 - r2);
        cA = c1 * corr;
        sA = s1 * corr;
    }
    T torque;
    if (SAT) {
        T v[N_CHANNELS];
        gather(lut, grid, i_d, i_q, v);
        torque = (T)args.p15 * (v[4] * i_q - v[5] * i_d);
    } else {
        torque = (T)args.p15 * (psi_p + (T)args.dl * i_d) * i_q;
    }
    static_cast<T*>(args.out[0])[b] = i_d;
    static_cast<T*>(args.out[1])[b] = i_q;
    static_cast<T*>(args.out[2])[b] = buf_d;
    static_cast<T*>(args.out[3])[b] = buf_q;
    static_cast<T*>(args.out[4])[b] = torque;
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;
static constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

template <typename T, bool SAT, int DEADTIME>
static int launch_one(const PmsmFastArgs& args, cudaStream_t stream) {
    const size_t smem = SAT ? (size_t)N_CHANNELS * args.nx * args.ny * sizeof(T) : 0;
    if (smem > STATIC_SMEM_LIMIT) {
        // above 48 KB a launch is refused unless the kernel opts in
        const cudaError_t err = cudaFuncSetAttribute(pmsm_fast_kernel<T, SAT, DEADTIME>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that no later launch reports it
            return (int)err;
        }
    }
    const unsigned blocks = (unsigned)((args.batch + THREADS - 1) / THREADS);
    pmsm_fast_kernel<T, SAT, DEADTIME><<<blocks, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <typename T, bool SAT>
static int launch_deadtime(const PmsmFastArgs& args, cudaStream_t stream) {
    switch (args.deadtime) {
        case 0: return launch_one<T, SAT, 0>(args, stream);
        case 1: return launch_one<T, SAT, 1>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_dtype(const PmsmFastArgs& args, cudaStream_t stream) {
    return args.saturated ? launch_deadtime<T, true>(args, stream) : launch_deadtime<T, false>(args, stream);
}

extern "C" int pmsm_fast_args_size() { return (int)sizeof(PmsmFastArgs); }

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success): a refused launch never runs, and only this code reports it.
extern "C" int pmsm_fast_launch(const PmsmFastArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
