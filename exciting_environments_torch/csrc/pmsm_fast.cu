// Trig-free PMSM drive rollout: the whole drive step (action denormalization,
// inverter hexagon at the carried deadtime-advanced angle, deadtime buffer,
// LUT-gathered or linear Euler step of the currents, rotation carry) for T
// steps in one launch, streaming only the normalized actions, with the
// carry's start and the final angle computed in the launch too.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py::
// _make_kernel (+ _hex_clip_tiles; launcher _fast_core), and the eager start
// and end that ops/pmsm_fast.py runs around its step loop.  Per drive, as
// ops/pmsm_fast.py::pmsm_fast_rollout (fast_start, plain_pmsm_fast_rollout,
// fast_final_angle):
//   start: delta = omega * tau, adv0 = eps + ((deadtime + 0.5) * tau) * omega,
//   (cA, sA) = (cos, sin)(adv0), (c_delta, s_delta) = (cos, sin)(delta);
//   per step: u = a * scale + offset, n = u * 2 / u_dc;
//   (alpha, beta) = rotation of n by the carried (cA, sA);
//   the hexagon clip: sector bits from linear sign tests, the sector
//   rotation from the table ops/transforms.py ROTATION_RE/IM at [b0][b1][b2],
//   the clamp to the top sector's rectangle, the rotation back;
//   u_c = rotation back to dq, * u_dc / 2; deadtime 1: the buffer drives the
//   currents and takes u_c;
//   di = L^-1 (u - r_s i - omega J psi) from the six gathered channels
//   (saturated), or the linear ODE; i += tau di;
//   (cA, sA) advanced by (c_delta, s_delta), renormalized to first order;
//   end: the torque from one more gather at the final currents, and the
//   angle wrap_angle_fast(eps + T * delta).
//
// What bounds it on an H100: at the main size (saturated BRUSA, B = 65,536,
// T = 256, float32) the step is about 166 float32 operations per drive
// (2.8e9 in all, 0.042 ms at 67 TFLOP/s) and the normalized action slab 134
// MB (0.040 ms at 3.35 TB/s): the operations bound it, the bytes close
// behind.  In fact one dependent chain per drive sets the time: the
// gather's data-dependent shared-memory loads, the sector's rotation, the
// inductance inverse.  The first version issued 24 scalar loads per gather
// from the stacked (6, nx, ny) table, read the sector rotation as a
// run-time index into the kernel's double parameters (converted every
// step), loaded each action component apart, and left the carry's start,
// the final angle and the contiguous copies of broadcast leaves (and of a
// batch-major slab, transposed) to eager PyTorch around the launch.
//
// What the design does about it: one thread per drive keeps i_d, i_q, cA,
// sA, the deadtime buffer, omega and the rotation constants in registers
// for all T steps (keep(): no constant is reconverted in the loop).  The
// magnetics table comes channel-interleaved, (nx, ny, 8)
// (ops/lut.py::interleave_channels), and the block copies it to dynamic
// shared memory with each grid point's quad (channels 0-3, 16-byte loads)
// and pair (channels 4-5, one 8-byte load in float32, 16-byte in float64)
// placed inside the point by its index (pair_slot, quad_half): a warp whose
// drives gather all over the table then meets all 32 banks, where fixed
// offsets in 32-byte points use half of them for the quad and a quarter
// for the pair (bank conflicts that made the fixed layout, and the stacked
// (6, nx, ny) one, slower on drives held inside their current bands).  A
// gather is eight loads (gather_placed: gather_il's blend term for term,
// 0.0 against ops/lut.py::bilinear_gather).  The eight sector rotations
// follow as (re, im) pairs in the working type, one 8- or 16-byte load by
// the sector index.  128 threads per block: with 47,552 B per block for
// BRUSA four blocks (16 warps) share an SM in float32, two in float64
// (95,104 B, after cudaFuncSetAttribute; pmsm_fast_smem_bytes is the one
// sizing).  The action pair of a step is one 8- or 16-byte load, from
// either layout in place ((T, B, 2) rows B * 2 apart, (B, T, 2) rows 2
// apart: a run-time field, not a template parameter), issued one step
// ahead.  The carry's start (the literal sin and cos of each angle, once
// per drive) and the final angle are computed in the launch, and the
// per-drive leaves are read in place with their element stride (0 for a
// broadcast scalar), so PMSM.fast_rollout on the card is this one launch.
// The TPU kernel's one-hot gather encodings (int8x4, bf16x3), its 2 MB
// chunk budget, its (8, 128) tiles and batch % 1024 have no counterpart:
// any B runs, float32 and float64.
//
// Exactness: every operation mirrors the plain version in order and in the
// working precision, built with --fmad=false (eager_rules.cuh): the
// constants arrive folded in double as Python folds them, the divisions by
// the inductance determinant are true divisions, the clamps compare, a
// multiply by a Python number rounds the number to the working type first,
// and the start's sinf/cosf (sin/cos) are held against torch.sin/torch.cos
// on the card (chip_smoke.py's trig phase: every float32 |x| < 2^8, seeded
// values beyond and in float64).

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "fastmath.cuh"
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
    double adv_scale;                   // (deadtime + 0.5) * tau, folded in Python
    double rot_re[8], rot_im[8];        // ops/transforms.py ROTATION_RE/IM at [b0][b1][b2]
    const void* lut;                    // (nx, ny, 8) interleaved, saturated only
    const void* actions;                // normalized, (T, B, 2), or (B, T, 2) with batch_major
    const void* leaf[6];                // (B,) i_d, i_q, epsilon, omega_el, u_d_buffer, u_q_buffer
    long long leaf_stride[6];           // their element strides (0: a broadcast scalar)
    void* out[6];                       // (B,) i_d, i_q, u_d_buffer, u_q_buffer, torque, epsilon
    long long batch;
    int nx, ny;
    int n_steps;
    int saturated;
    int deadtime;                       // 0 or 1
    int batch_major;                    // layout of the action slab
};

enum { L_ID = 0, L_IQ = 1, L_EPS = 2, L_OMEGA = 3, L_BUF_D = 4, L_BUF_Q = 5 };

// A pair of T in one 8-byte (float) or 16-byte (double) load.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
    using type = float2;
};
template <>
struct Pair<double> {
    using type = double2;
};

// Dynamic shared memory of one block, in elements of T: the table (16-byte
// aligned, first), then the eight rotations as (re, im).  The only sizing
// of it: the wrapper asks pmsm_fast_smem_bytes.
__host__ __device__ __forceinline__ size_t table_elems(const PmsmFastArgs& args, bool sat) {
    return sat ? (size_t)N_CHANNELS_PAD * args.nx * args.ny : 0;
}
template <typename T>
static size_t smem_bytes(const PmsmFastArgs& args) {
    return (table_elems(args, args.saturated) + 16) * sizeof(T);
}

// The table in shared memory holds each grid point p's eight elements of
// ops/lut.py::interleave_channels as a quad (channels 0-3) and a pair
// (channels 4-5) placed by p: the pair in the pair slot pair_slot(p) of
// four, the quad in the half of the point that slot leaves free.  A warp
// that gathers at spread points so meets all 32 banks with both loads,
// where the points' fixed offsets would use a quarter of them for the pair
// and half for the quad.
__device__ __forceinline__ int pair_slot(int p) { return (p >> 2) & 3; }
__device__ __forceinline__ int quad_half(int p) { return 1 - (pair_slot(p) >> 1); }

// One grid point's six channels from the shared-memory table: the quad in
// 16-byte loads, the pair in one 8- (float) or 16-byte (double) load.
template <typename T>
__device__ __forceinline__ void load_point(const T* __restrict__ table, int p, T (&c)[N_CHANNELS]) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::N;
    const T* point = table + p * N_CHANNELS_PAD;
#pragma unroll
    for (int g = 0; g < 4 / W; ++g) {
        const V q = reinterpret_cast<const V*>(point + quad_half(p) * 4)[g];
        const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int w = 0; w < W; ++w) c[g * W + w] = e[w];
    }
    const typename Pair<T>::type r = reinterpret_cast<const typename Pair<T>::type*>(point)[pair_slot(p)];
    c[4] = r.x;
    c[5] = r.y;
}

// gather_il of pmsm_drive.cuh over the placed table: the cell, weights and
// blend term for term (so 0.0 against ops/lut.py::bilinear_gather)
template <typename T>
__device__ __forceinline__ void gather_placed(const T* __restrict__ table, const Drive<T>& k, T px, T py,
                                              T (&v)[N_CHANNELS]) {
    const T fx = (px - k.x0) / k.dx;
    const T fy = (py - k.y0) / k.dy;
    const int ix = cell(fx, k.nx);
    const int iy = cell(fy, k.ny);
    const T wx = fx - (T)ix;
    const T wy = fy - (T)iy;
    const T owx = T(1) - wx;
    const T owy = T(1) - wy;
    const int p00 = ix * k.ny + iy;
    T c00[N_CHANNELS], c01[N_CHANNELS], c10[N_CHANNELS], c11[N_CHANNELS];
    load_point(table, p00, c00);
    load_point(table, p00 + 1, c01);
    load_point(table, p00 + k.ny, c10);
    load_point(table, p00 + k.ny + 1, c11);
#pragma unroll
    for (int c = 0; c < N_CHANNELS; ++c)
        v[c] = c00[c] * owx * owy + c01[c] * owx * wy + c10[c] * wx * owy + c11[c] * wx * wy;
}

// torch.sin(x) and torch.cos(x) for the carry's start: the literal calls
// (once per drive, outside the step loop)
__device__ __forceinline__ void start_sincos(float x, float& s, float& c) {
    s = sinf(x);
    c = cosf(x);
}
__device__ __forceinline__ void start_sincos(double x, double& s, double& c) {
    s = sin(x);
    c = cos(x);
}

// ops/pmsm_fast.py::fast_start: (cA, sA) at the deadtime-advanced angle and
// the per-step rotation (c_delta, s_delta)
template <typename T>
__device__ __forceinline__ void fast_start(const PmsmFastArgs& args, T eps, T omega, T& cA, T& sA, T& c_delta,
                                           T& s_delta) {
    const T delta = omega * (T)args.tau;
    const T adv0 = eps + omega * (T)args.adv_scale;
    start_sincos(adv0, sA, cA);
    start_sincos(delta, s_delta, c_delta);
}

// ops/pmsm_fast.py::fast_final_angle: wrap_angle_fast(eps + n_steps * (omega * tau))
template <typename T>
__device__ __forceinline__ T fast_final_angle(const PmsmFastArgs& args, T eps, T omega) {
    return wrap_angle_fast(eps + (omega * (T)args.tau) * (T)args.n_steps);
}

// ops/pmsm_fast.py::hex_clip_fast, the sector rotation from the (re, im)
// pairs in shared memory
template <typename T>
__device__ __forceinline__ void hex_clip_fast(const typename Pair<T>::type* rot, T& alpha, T& beta) {
    const T s120 = (T)0.8660254037844386;
    const int b0 = beta >= T(0);
    const int b1 = (T)-0.5 * beta - s120 * alpha >= T(0);
    const int b2 = (T)-0.5 * beta + s120 * alpha >= T(0);
    const typename Pair<T>::type r = rot[b0 * 4 + b1 * 2 + b2];
    const T rot_re = r.x, rot_im = r.y;
    T ra = alpha * rot_re - beta * rot_im;
    T rb = alpha * rot_im + beta * rot_re;
    ra = clampv(ra, (T)(-2.0 / 3.0), (T)(2.0 / 3.0));
    rb = clampv(rb, T(0), (T)(2.0 / 3.0 * 1.7320508075688772));
    alpha = ra * rot_re + rb * rot_im;
    beta = rb * rot_re - ra * rot_im;
}

// A per-drive leaf, read in place with its element stride.
template <typename T>
__device__ __forceinline__ T leaf(const PmsmFastArgs& args, int i, long long b) {
    return static_cast<const T*>(args.leaf[i])[b * args.leaf_stride[i]];
}

static constexpr int THREADS = 128;

template <typename T, bool SAT, int DEADTIME>
__global__ void __launch_bounds__(THREADS) pmsm_fast_kernel(const __grid_constant__ PmsmFastArgs args) {
    using P = typename Pair<T>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* lut = reinterpret_cast<T*>(smem_raw);
    P* rot = reinterpret_cast<P*>(lut + table_elems(args, SAT));
    {
        // every thread of the block takes part before any returns
        if (threadIdx.x < 8) {
            P r;
            r.x = (T)args.rot_re[threadIdx.x];
            r.y = (T)args.rot_im[threadIdx.x];
            rot[threadIdx.x] = r;
        }
        if (SAT) {
            using V = typename Vec16<T>::type;
            constexpr int W = Vec16<T>::N;
            const int n = args.nx * args.ny;
            const T* tab = static_cast<const T*>(args.lut);
            for (int p = threadIdx.x; p < n; p += blockDim.x) {
                const T* src = tab + p * N_CHANNELS_PAD;
                T* dst = lut + p * N_CHANNELS_PAD;
#pragma unroll
                for (int g = 0; g < 4 / W; ++g)
                    reinterpret_cast<V*>(dst + quad_half(p) * 4)[g] = reinterpret_cast<const V*>(src)[g];
                reinterpret_cast<P*>(dst)[pair_slot(p)] = reinterpret_cast<const P*>(src)[2];
            }
        }
        __syncthreads();
    }
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const int n_steps = args.n_steps;

    // the table's grid, for the gather of pmsm_drive.cuh
    Drive<T> grid;
    grid.x0 = (T)args.x0;
    grid.y0 = (T)args.y0;
    grid.dx = divisor(weak_const<T>(args.dx));
    grid.dy = divisor(weak_const<T>(args.dy));
    grid.nx = args.nx;
    grid.ny = args.ny;
    keep(grid.x0);
    keep(grid.y0);
    keep(grid.dx.v);
    keep(grid.dy.v);

    T tau = (T)args.tau, r_s = (T)args.r_s;
    T l_d = (T)args.l_d, l_q = (T)args.l_q, psi_p = (T)args.psi_p;
    T inv_ld = (T)args.inv_ld, inv_lq = (T)args.inv_lq;
    T a_scale_d = (T)args.a_scale_d, a_off_d = (T)args.a_off_d;
    T a_scale_q = (T)args.a_scale_q, a_off_q = (T)args.a_off_q;
    T to_halfdc = (T)args.to_halfdc, from_halfdc = (T)args.from_halfdc;
    keep(tau);
    keep(r_s);
    keep(a_scale_d);
    keep(a_off_d);
    keep(a_scale_q);
    keep(a_off_q);
    keep(to_halfdc);
    keep(from_halfdc);
    if (!SAT) {
        keep(l_d);
        keep(l_q);
        keep(psi_p);
        keep(inv_ld);
        keep(inv_lq);
    }

    T i_d = leaf<T>(args, L_ID, b);
    T i_q = leaf<T>(args, L_IQ, b);
    const T eps = leaf<T>(args, L_EPS, b);
    const T omega = leaf<T>(args, L_OMEGA, b);
    T buf_d = leaf<T>(args, L_BUF_D, b);
    T buf_q = leaf<T>(args, L_BUF_Q, b);
    T cA, sA, c_delta, s_delta;
    fast_start(args, eps, omega, cA, sA, c_delta, s_delta);

    // the action rows, read in place from either layout, one row ahead
    const long long row_stride = args.batch_major ? 1 : args.batch;  // in pairs
    const P* __restrict__ next_row = static_cast<const P*>(args.actions) + (args.batch_major ? b * n_steps : b);
    P a_next{};
    if (n_steps > 0) a_next = __ldg(next_row);

#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
        const P a = a_next;
        if (t + 1 < n_steps) {
            next_row += row_stride;
            a_next = __ldg(next_row);  // in flight during this step
        }
        const T u_d = a.x * a_scale_d + a_off_d;
        const T u_q = a.y * a_scale_q + a_off_q;
        const T nd = u_d * to_halfdc;
        const T nq = u_q * to_halfdc;
        T alpha = cA * nd - sA * nq;
        T beta = sA * nd + cA * nq;
        hex_clip_fast<T>(rot, alpha, beta);
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
            gather_placed(lut, grid, i_d, i_q, v);
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
        gather_placed(lut, grid, i_d, i_q, v);
        torque = (T)args.p15 * (v[4] * i_q - v[5] * i_d);
    } else {
        torque = (T)args.p15 * (psi_p + (T)args.dl * i_d) * i_q;
    }
    static_cast<T*>(args.out[0])[b] = i_d;
    static_cast<T*>(args.out[1])[b] = i_q;
    static_cast<T*>(args.out[2])[b] = buf_d;
    static_cast<T*>(args.out[3])[b] = buf_q;
    static_cast<T*>(args.out[4])[b] = torque;
    static_cast<T*>(args.out[5])[b] = fast_final_angle(args, eps, omega);
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

using KernelFn = void (*)(PmsmFastArgs);

// The instantiation that args and dtype (0 float32, 1 float64) select, and
// its dynamic shared memory; no kernel for a deadtime other than 0 or 1.
struct Selected {
    KernelFn fn;
    size_t smem;
};

template <typename T>
static Selected select_typed(const PmsmFastArgs& args) {
    KernelFn fn = nullptr;
    if (args.deadtime == 0) fn = args.saturated ? pmsm_fast_kernel<T, true, 0> : pmsm_fast_kernel<T, false, 0>;
    if (args.deadtime == 1) fn = args.saturated ? pmsm_fast_kernel<T, true, 1> : pmsm_fast_kernel<T, false, 1>;
    return {fn, smem_bytes<T>(args)};
}

static Selected select_kernel(const PmsmFastArgs& args, int dtype) {
    return dtype == 0 ? select_typed<float>(args) : select_typed<double>(args);
}

// Opt the kernel in above 48 KB of dynamic shared memory; the error state
// is cleared if that is refused, so that no later launch reports it.
static cudaError_t allow_smem(const Selected& k) {
    if (k.fn == nullptr) return cudaErrorInvalidValue;
    if (k.smem <= STATIC_SMEM_LIMIT) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k.fn),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

extern "C" int pmsm_fast_args_size() { return (int)sizeof(PmsmFastArgs); }

// The dynamic shared memory of one block of the kernel that args selects.
extern "C" long long pmsm_fast_smem_bytes(const PmsmFastArgs* args, int dtype) {
    return (long long)select_kernel(*args, dtype).smem;
}

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success): a refused launch never runs, and only this code reports it.
extern "C" int pmsm_fast_launch(const PmsmFastArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    const Selected k = select_kernel(*args, dtype);
    cudaError_t err = allow_smem(k);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((args->batch + THREADS - 1) / THREADS);
    void* params[] = {const_cast<PmsmFastArgs*>(args)};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), dim3(blocks), dim3(THREADS), params, k.smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) cudaGetLastError();
    return (int)err;
}

// The blocks of the kernel that args selects which fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int pmsm_fast_blocks_per_sm(const PmsmFastArgs* args, int dtype, int* blocks) {
    const Selected k = select_kernel(*args, dtype);
    const cudaError_t err = allow_smem(k);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, reinterpret_cast<const void*>(k.fn), THREADS,
                                                             k.smem);
}

// ---------------------------------------------------------------------------
// The start's trigonometry, checked on the card
// ---------------------------------------------------------------------------

// start_sincos for n values: the caller holds s and c against torch.sin and
// torch.cos bit for bit (ops/kernels/pmsm_fast_kernel.py::start_trig_mismatches)
template <typename T>
__global__ void start_trig_kernel(const T* __restrict__ x, T* __restrict__ s, T* __restrict__ c, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        T si, co;
        start_sincos(x[i], si, co);
        s[i] = si;
        c[i] = co;
    }
}

extern "C" int pmsm_fast_start_trig(const void* x, void* s, void* c, long long n, int dtype, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        start_trig_kernel<float><<<132 * 16, 256, 0, st>>>(static_cast<const float*>(x), static_cast<float*>(s),
                                                           static_cast<float*>(c), n);
    else
        start_trig_kernel<double><<<132 * 16, 256, 0, st>>>(static_cast<const double*>(x), static_cast<double*>(s),
                                                            static_cast<double*>(c), n);
    return (int)cudaGetLastError();
}
