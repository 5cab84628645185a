// Fused open-loop rollout of a classic ODE environment: the whole horizon of
// T explicit Runge-Kutta steps in one launch.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/stepper.py::
// _make_kernel (+ _launch), in both of its modes:
//   * step mode: identical to T repeated vmap_step calls (wrap angles and
//     clip after every step, optional process-noise increments added after
//     wrap/clip and followed by a second wrap/clip);
//   * sim-ahead mode: identical to vmap_sim_ahead (the carry is never
//     wrapped, stages at c == 1 read the next zero-order-hold action).
//
// What bounds it on an H100: the action slab.  Each instance streams
// T * A action values once; the state is a handful of registers.  At the
// main size (pendulum, B = 65,536, T = 4,096, float32) that is 1.07 GB, or
// 0.32 ms at 3.35 TB/s, against a few dozen float32 operations per step and
// instance (well under 0.1 ms at 67 TFLOP/s).  So the kernel is bound by
// bytes, and in practice by the latency of each step's dependent load.
//
// What the design does about it: one thread per instance keeps its state in
// registers for all T steps and reads the time-major slab a[t, b, :], so
// neighbouring threads read neighbouring addresses and every action byte is
// read exactly once.  The denormalization of the action is folded into the
// kernel (no pre-pass over the slab), the next-action stream of sim-ahead
// mode is read from the same slab one row ahead (no shifted copy), and an
// action held for R solver steps is read R times from cache (no repeated
// copy).  The TPU kernel's (8, 128) tiles, VMEM chunk budgets and revisited
// output blocks have no counterpart; any batch size works (the ragged edge
// is masked).  Load prefetching across steps is left for later work.
//
// Exactness: every operation mirrors the PyTorch plain version
// (exciting_environments_torch/ops/kernels/stepper.py::plain_rollout) in
// order and in working precision.  Build with --fmad=false so that y + h*f
// is not contracted into an FMA.  Scalar parameters arrive as host doubles
// and fold in double precision where the Python code folds Python numbers
// (Weak in eager_rules.cuh); per-batch parameters arrive as device pointers.
// The environments' vector fields live in classic_envs.cuh, shared with the
// closed-loop kernel (closed_loop.cu).  An environment made with
// fast_math=True (the JAX kernel's fast_wrap) runs the FastMath functors and
// wraps with wrap_angle_fast (args.fast); only the environments with
// trigonometry, Pendulum and CartPole, have fast instantiations.

#include <cuda_runtime.h>
#include <math.h>

#include "classic_envs.cuh"
#include "eager_rules.cuh"

#define MAX_STAGES 7
#define MAX_STATE 4
#define MAX_ACTION 2
#define MAX_PARAMS 8

// Mirrored field for field by StepperArgs in ops/kernels/stepper.py.
struct StepperArgs {
    double tau;
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double param_value[MAX_PARAMS];    // scalar parameter (param_ptr null)
    double act_min_value[MAX_ACTION];  // scalar normalization bound (ptr null)
    double act_max_value[MAX_ACTION];
    const void* param_ptr[MAX_PARAMS];  // per-batch parameter (B,), or null
    const void* act_min_ptr[MAX_ACTION];
    const void* act_max_ptr[MAX_ACTION];
    const void* y0[MAX_STATE];          // (B,) per state leaf
    void* y_out[MAX_STATE];             // (B,) per state leaf
    void* traj[MAX_STATE];              // (T / traj_stride, B) per leaf, or null
    const void* actions;                // normalized, (T / hold, B, A)
    const void* noise;                  // (T, B, n_noise), or null
    long long batch;
    int n_steps;
    int n_stages;                       // stages evaluated (the FSAL last one is skipped)
    int hold;                           // solver steps per action row
    int sim_ahead;
    int wrap[MAX_STATE];
    int use_next[MAX_STAGES];           // stage reads the next action (sim-ahead, c == 1)
    int noise_idx[MAX_STATE];
    int n_noise;
    int traj_stride;                    // 0: no trajectory saves
    int env_id;
    int fast;                           // the environment's fast_math (FastMath functors and wrap)
};

// ---------------------------------------------------------------------------
// The rollout kernel
// ---------------------------------------------------------------------------

template <typename T, class Env>
__device__ __forceinline__ void postprocess(T* y, const StepperArgs& args) {
#pragma unroll
    for (int i = 0; i < Env::N_STATE; ++i)
        if (args.wrap[i]) y[i] = Env::Math::wrap(y[i]);
    Env::clip(y);
}

// MinMaxNormalization.denormalize: (x + 1) / 2 * (max - min) + min
template <typename T, int A>
__device__ __forceinline__ void load_action(T* u, const T* slab, long long row, long long b, long long batch,
                                            const T* span, const T* lo) {
#pragma unroll
    for (int j = 0; j < A; ++j) {
        const T x = slab[(row * batch + b) * A + j];
        u[j] = (x + T(1)) / T(2) * span[j] + lo[j];
    }
}

template <typename T, class Env, int NS>
__global__ void __launch_bounds__(128) stepper_kernel(const __grid_constant__ StepperArgs args) {
    constexpr int N = Env::N_STATE;
    constexpr int A = Env::N_ACTION;
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const long long batch = args.batch;

    const ParamView params{args.param_value, args.param_ptr};
    const typename Env::template Consts<T> k = Env::template prepare<T>(params, b);
    T span[A], lo[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
        const Weak<T> mn = weak_load<T>(args.act_min_ptr[j], args.act_min_value[j], b);
        const Weak<T> mx = weak_load<T>(args.act_max_ptr[j], args.act_max_value[j], b);
        span[j] = value(wsub(mx, mn));
        lo[j] = value(mn);
    }

    T y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = static_cast<const T*>(args.y0[i])[b];

    const T tau = (T)args.tau;
    const T* slab = static_cast<const T*>(args.actions);
    const T* noise = static_cast<const T*>(args.noise);
    const int n_rows = args.n_steps / args.hold;
    bool has_next = false;
#pragma unroll
    for (int s = 0; s < NS; ++s) has_next = has_next || args.use_next[s];

    for (int t = 0; t < args.n_steps; ++t) {
        T u[A], un[A];
        load_action<T, A>(u, slab, t / args.hold, b, batch, span, lo);
        if (has_next) {
            const int row_next = min((t + 1) / args.hold, n_rows - 1);
            load_action<T, A>(un, slab, row_next, b, batch, span, lo);
        }

        T ks[NS][N];
        Env::ode(k, y, u, ks[0]);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
            T yi[N], us[A];
#pragma unroll
            for (int i = 0; i < N; ++i) yi[i] = lincomb<T, NS, N>(y[i], ks, i, args.a[s], s, tau);
#pragma unroll
            for (int j = 0; j < A; ++j) us[j] = args.use_next[s] ? un[j] : u[j];
            Env::ode(k, yi, us, ks[s]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) y[i] = lincomb<T, NS, N>(y[i], ks, i, args.b, NS, tau);

        if (!args.sim_ahead) {
            postprocess<T, Env>(y, args);
            if (args.n_noise > 0) {
#pragma unroll
                for (int j = 0; j < MAX_STATE; ++j) {
                    if (j < args.n_noise) {
                        const T dn = noise[((long long)t * batch + b) * args.n_noise + j];
#pragma unroll
                        for (int i = 0; i < N; ++i)
                            if (args.noise_idx[j] == i) y[i] = y[i] + dn;
                    }
                }
                postprocess<T, Env>(y, args);
            }
        }
        if (args.traj_stride > 0 && (t + 1) % args.traj_stride == 0) {
            const long long slot = (t + 1) / args.traj_stride - 1;
#pragma unroll
            for (int i = 0; i < N; ++i) static_cast<T*>(args.traj[i])[slot * batch + b] = y[i];
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) static_cast<T*>(args.y_out[i])[b] = y[i];
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;

template <typename T, class Env, int NS>
static void launch_one(const StepperArgs& args, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((args.batch + THREADS - 1) / THREADS);
    stepper_kernel<T, Env, NS><<<blocks, THREADS, 0, stream>>>(args);
}

template <typename T, class Env>
static int launch_env(const StepperArgs& args, cudaStream_t stream) {
    switch (args.n_stages) {
        case 1: launch_one<T, Env, 1>(args, stream); break;
        case 2: launch_one<T, Env, 2>(args, stream); break;
        case 3: launch_one<T, Env, 3>(args, stream); break;
        case 4: launch_one<T, Env, 4>(args, stream); break;
        case 5: launch_one<T, Env, 5>(args, stream); break;
        case 6: launch_one<T, Env, 6>(args, stream); break;
        case 7: launch_one<T, Env, 7>(args, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_dtype(const StepperArgs& args, cudaStream_t stream) {
    switch (args.env_id) {
        case 0:
            return args.fast ? launch_env<T, PendulumEnv<FastMath>>(args, stream)
                             : launch_env<T, PendulumEnv<ExactMath>>(args, stream);
        case 1: return launch_env<T, MassSpringDamperEnv>(args, stream);
        case 2:
            return args.fast ? launch_env<T, CartPoleEnv<FastMath>>(args, stream)
                             : launch_env<T, CartPoleEnv<ExactMath>>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int stepper_args_size() { return (int)sizeof(StepperArgs); }

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
extern "C" int stepper_launch(const StepperArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
