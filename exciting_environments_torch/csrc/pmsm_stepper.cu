// PMSM drive current integration: the whole horizon of T explicit
// Runge-Kutta steps of the electrical dynamics (i_d, i_q) of every drive
// instance in one launch, over a pre-constrained voltage stream.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pmsm_stepper.py::
// _make_kernel (with _gather_corners and _blend_channels; launcher
// _pmsm_fused_core), in both of its modes:
//   * step mode (pmsm_fused_rollout): identical to T repeated vmap_step calls
//     of the current subsystem;
//   * sim-ahead mode (pmsm_fused_sim_ahead): stages at c == 1 read the next
//     applied voltage.
// The angle recurrence and the inverter hexagon are state-independent given
// the actions (omega_el is frozen), so an eager PyTorch pre-pass computes the
// constrained voltages u_con (T, B, 2) and the angles before the launch
// (ops/kernels/pmsm_stepper.py::_constrained_voltages).
//
// Per stage: a bilinear gather of the six magnetics channels (L_dd, L_dq,
// L_qd, L_qq, Psi_d, Psi_q) at (i_d, i_q) with the closed-form 2x2 inverse of
// the differential inductance matrix (saturated), or the linear ODE; torque
// at every trajectory save and at the end.
//
// What bounds it on an H100: the voltage stream.  Each instance reads its
// 2 T voltages once; the state is two registers.  At the main size (BRUSA,
// B = 65,536, T = 256, float32) that is 134 MB, or 0.040 ms at 3.35 TB/s,
// against about 110 float32 operations per Euler step and instance (1.8e9 in
// all, 0.028 ms at 67 TFLOP/s).  So bytes set the bound.  In practice the
// gather costs more than either: 24 shared-memory loads per stage and
// instance (4 corners x 6 channels) at data-dependent addresses, so bank
// conflicts serialize part of every gather, behind the latency of each
// step's dependent global load.
//
// What the design does about it: one thread per instance keeps (i_d, i_q)
// and omega_el in registers for all T steps and reads the time-major stream
// u_con[t, b, :], so neighbouring threads read neighbouring addresses and
// every voltage is read once.  The LUT is copied into shared memory by each
// block at its start (6 nx ny values: 35,616 B for BRUSA in float32, 71,232 B
// in float64, above 48 KB only as dynamic shared memory after
// cudaFuncSetAttribute), and every corner is then a direct indexed load: a
// plain load is exact, so none of the TPU's one-hot MXU encodings is needed.
// The layout in shared memory is build_pmsm_lut's (C, nx, ny): channel c of
// corner (ix, iy) sits at (c * nx + ix) * ny + iy.  The deadtime shift reads
// row t - 1 of u_con and the initial buffer at t = 0, and the sim-ahead next
// voltage reads row t + 1 of the same stream clamped at T - 1: no shifted
// copy is made.  The TPU's (8, 128) tiles, time chunks with revisited output
// blocks and VMEM budgets have no counterpart; any B works (the ragged edge
// is masked).
//
// The drive model (Drive, prepare, the gather, ode and torque) lives in
// pmsm_drive.cuh, shared with the closed-loop kernel pmsm_closed_loop.cu.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/pmsm_stepper.py::plain_pmsm_rollout, which calls the
// environment's own nonlinear_ode / linear_ode and torque maps) in order and
// working precision, built with --fmad=false (eager_rules.cuh):
//   (a) (i_d - x0) / dx and (i_q - y0) / dy divide by Python numbers, and so
//       do the linear ODE's / l_d and / l_q when they are scalars: on
//       PyTorch's CUDA eager path a multiply by the reciprocal taken in
//       double (Divisor);
//   (b) tensor-by-tensor divisions (l_qq / det, ...) are true divisions;
//   (c) scalars fold in double where Python folds them: 3 / 2 * p is 4.5
//       before it meets a tensor, and so is l_d - l_q (Weak);
//   (d) floor, then the clamp to [0, n - 2], then the conversion to integer,
//       and w = f - i in the working type, as lut.py::bilinear_gather does;
//   (e) the sim-ahead angle extrapolation is not in the kernel: one host
//       helper (pmsm_env.py::extrapolated_angles) serves both sim_ahead and
//       fused_sim_ahead.

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "pmsm_drive.cuh"

#define MAX_STAGES 7

// Mirrored field for field by PmsmArgs in ops/kernels/pmsm_stepper.py.
struct PmsmArgs {
    double tau;
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double param_value[N_PARAMS];      // scalar parameter (param_ptr null)
    double x0, dx, y0, dy;             // LUT grid (Python numbers)
    const void* param_ptr[N_PARAMS];   // per-batch parameter (B,), or null
    const void* lut;                   // (6, nx, ny), saturated only
    const void* u_con;                 // (T, B, 2) constrained physical voltages
    const void* buf0[2];               // (B,) initial deadtime buffer (u_d, u_q)
    const void* i_d0;                  // (B,)
    const void* i_q0;
    const void* omega;
    void* out[3];                      // (B,) final i_d, i_q, torque
    void* traj[3];                     // (T / traj_stride, B) saves, or null
    long long batch;
    int nx, ny;
    int n_steps;
    int n_stages;                      // stages evaluated (the FSAL last one is skipped)
    int saturated;
    int deadtime;                      // 0 or 1
    int traj_stride;                   // 0: no trajectory saves
    int use_next[MAX_STAGES];          // stage reads the next voltage (sim-ahead, c == 1)
};

// The voltage applied at step `row`: the deadtime buffer at row 0, else the
// constrained voltage `deadtime` rows earlier.
template <typename T>
__device__ __forceinline__ void applied(const PmsmArgs& args, const T* __restrict__ u_con, int row, long long b,
                                        T buf_d, T buf_q, T& u_d, T& u_q) {
    if (args.deadtime && row == 0) {
        u_d = buf_d;
        u_q = buf_q;
        return;
    }
    const long long i = ((long long)(row - args.deadtime) * args.batch + b) * 2;
    u_d = u_con[i];
    u_q = u_con[i + 1];
}

template <typename T, int NS, bool SAT>
__global__ void __launch_bounds__(128) pmsm_kernel(const __grid_constant__ PmsmArgs args) {
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

    const Drive<T> k = prepare<T>(args, b);  // pmsm_drive.cuh
    const T* u_con = static_cast<const T*>(args.u_con);
    const T buf_d = static_cast<const T*>(args.buf0[0])[b];
    const T buf_q = static_cast<const T*>(args.buf0[1])[b];
    const T tau = (T)args.tau;
    bool has_next = false;
#pragma unroll
    for (int s = 0; s < NS; ++s) has_next = has_next || args.use_next[s];

    T y[2] = {static_cast<const T*>(args.i_d0)[b], static_cast<const T*>(args.i_q0)[b]};
    for (int t = 0; t < args.n_steps; ++t) {
        T u_d, u_q, un_d = T(0), un_q = T(0);
        applied<T>(args, u_con, t, b, buf_d, buf_q, u_d, u_q);
        if (has_next) applied<T>(args, u_con, min(t + 1, args.n_steps - 1), b, buf_d, buf_q, un_d, un_q);

        T ks[NS][2];
        ode<T, SAT>(lut, k, y, u_d, u_q, ks[0]);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
            const T yi[2] = {lincomb<T, NS, 2>(y[0], ks, 0, args.a[s], s, tau),
                             lincomb<T, NS, 2>(y[1], ks, 1, args.a[s], s, tau)};
            const bool nxt = args.use_next[s];
            ode<T, SAT>(lut, k, yi, nxt ? un_d : u_d, nxt ? un_q : u_q, ks[s]);
        }
        const T y0 = lincomb<T, NS, 2>(y[0], ks, 0, args.b, NS, tau);
        const T y1 = lincomb<T, NS, 2>(y[1], ks, 1, args.b, NS, tau);
        y[0] = y0;
        y[1] = y1;

        if (args.traj_stride > 0 && (t + 1) % args.traj_stride == 0) {
            const long long slot = ((long long)((t + 1) / args.traj_stride - 1)) * args.batch + b;
            static_cast<T*>(args.traj[0])[slot] = y[0];
            static_cast<T*>(args.traj[1])[slot] = y[1];
            static_cast<T*>(args.traj[2])[slot] = torque<T, SAT>(lut, k, y[0], y[1]);
        }
    }
    static_cast<T*>(args.out[0])[b] = y[0];
    static_cast<T*>(args.out[1])[b] = y[1];
    static_cast<T*>(args.out[2])[b] = torque<T, SAT>(lut, k, y[0], y[1]);
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;
static constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

template <typename T, int NS, bool SAT>
static int launch_one(const PmsmArgs& args, cudaStream_t stream) {
    const size_t smem = SAT ? (size_t)N_CHANNELS * args.nx * args.ny * sizeof(T) : 0;
    if (smem > STATIC_SMEM_LIMIT) {
        // above 48 KB a launch is refused unless the kernel opts in
        const cudaError_t err =
            cudaFuncSetAttribute(pmsm_kernel<T, NS, SAT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that no later launch reports it
            return (int)err;
        }
    }
    const unsigned blocks = (unsigned)((args.batch + THREADS - 1) / THREADS);
    pmsm_kernel<T, NS, SAT><<<blocks, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <typename T, bool SAT>
static int launch_sat(const PmsmArgs& args, cudaStream_t stream) {
    switch (args.n_stages) {
        case 1: return launch_one<T, 1, SAT>(args, stream);
        case 2: return launch_one<T, 2, SAT>(args, stream);
        case 3: return launch_one<T, 3, SAT>(args, stream);
        case 4: return launch_one<T, 4, SAT>(args, stream);
        case 5: return launch_one<T, 5, SAT>(args, stream);
        case 6: return launch_one<T, 6, SAT>(args, stream);
        case 7: return launch_one<T, 7, SAT>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_dtype(const PmsmArgs& args, cudaStream_t stream) {
    return args.saturated ? launch_sat<T, true>(args, stream) : launch_sat<T, false>(args, stream);
}

extern "C" int pmsm_args_size() { return (int)sizeof(PmsmArgs); }

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success): a refused launch never runs, and only this code reports it.
extern "C" int pmsm_launch(const PmsmArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
