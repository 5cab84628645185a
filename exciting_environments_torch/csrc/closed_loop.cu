// Closed-loop rollout of a classic ODE environment with the policy inside the
// kernel: every step normalizes the state into the observation, evaluates the
// policy, denormalizes its action and takes the RK step, for the whole
// horizon of T steps in one launch.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/stepper.py::
// _make_closed_loop_kernel (+ _cl_launch).  Per step, in this order:
//   obs = 2 * (y - min) / (max - min) - 1 per state leaf, then the
//         normalized references; + the sensor-noise row on obs_cols;
//   a   = policy(obs, t[, carry]) (normalized), carry updated;
//   u   = (a + 1) / 2 * (max - min) + min, the RK step under u;
//   wrap angles and clip; + the process-noise row on noise_idx, wrap/clip;
//   every traj_stride steps save state, normalized action and carry.
//
// The policy.  Pallas traces any Python function into the kernel; a CUDA
// kernel cannot, so the policy families the library's users run are compiled
// in as functors (ops/policies.py holds their plain versions):
//   * AffineLaw (policy_laws.cuh): a_j = b_j + sum_i K[j][i] obs_i,
//     optionally a carried integrator c_j += sum_i Ki[j][i] obs_i added to
//     a_j, and a clamp (the PD and PI tracking laws);
//   * ActorLaw: the PPO actor of utils/rl_fused.py, a tanh MLP with a linear
//     head, plus exp(log_std_j) * z with z a counter-hash normal draw of
//     (instance id, step, action dim, seed), clamped to [-1, 1].
// Their parameters arrive as one flat vector that each block copies into
// shared memory once (the counterpart of the TPU's SMEM scalar path); every
// thread of a warp reads the same word, a broadcast.
//
// What bounds it on an H100: operations.  Without saves or noise the kernel
// streams nothing: each instance reads its state, references and
// parameters once and writes its final state once, and in between it does
// a few dozen float32 operations per step (PD/PI laws) or a few hundred (the
// actor, 2 x 16 x 16 multiply-adds plus tanh and the hash).  With saves
// every step (collection) the saves add 4 x (N + A + carry) bytes per step
// and instance.
//
// What the design does about it: one thread per instance keeps the state,
// the policy carry and the observation in registers for all T steps; the
// actor's activations (widths up to MAX_WIDTH, set at run time) live in a
// per-thread local array.  Noise slabs are read time-major (T, B, n) and
// saves written time-major (n_saves, B), so neighbouring threads touch
// neighbouring addresses.  The ragged edge of the batch is masked, so any B
// works.  The TPU kernel's (8, 128) tiles, time chunks, revisited output
// blocks and SMEM scalar tree have no counterpart.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/closed_loop.py::plain_cl_step with the policies' forward) in
// order and in working precision, under PyTorch's CUDA eager rules
// (eager_rules.cuh): the division of the normalization by the Python number
// (max - min) is a multiply by its reciprocal; the clamps compare, so that a
// NaN stays NaN as in torch.clamp; the hash runs on uint32 (wrap-around
// multiplies, logical shifts).  Build with --fmad=false.  With fast_math=True
// (args.fast, the JAX kernel's fast_wrap) the Pendulum and CartPole functors
// take the FastMath policy of classic_envs.cuh and the wrap is
// wrap_angle_fast.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "classic_envs.cuh"
#include "eager_rules.cuh"
#include "policy_laws.cuh"

#define MAX_STAGES 7
#define MAX_STATE 4
#define MAX_ACTION 2
#define MAX_PARAMS 8
#define MAX_REFS 4
#define MAX_OBS (MAX_STATE + MAX_REFS)
#define MAX_CARRY 4
#define MAX_LAYERS 4
#define MAX_WIDTH 64
#define MAX_POLICY_PARAMS 4096

// Mirrored field for field by ClosedLoopArgs in ops/kernels/closed_loop.py.
struct ClosedLoopArgs {
    double tau;
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double param_value[MAX_PARAMS];    // scalar parameter (param_ptr null)
    double obs_min[MAX_STATE];         // scalar observation normalization per state leaf
    double obs_max[MAX_STATE];
    double act_min[MAX_ACTION];        // scalar action normalization
    double act_max[MAX_ACTION];
    double clip;                       // AffineLaw clamp bound (with has_clip)
    const void* param_ptr[MAX_PARAMS];  // per-batch parameter (B,), or null
    const void* y0[MAX_STATE];          // (B,) per state leaf
    const void* carry0[MAX_CARRY];      // (B,) per policy-carry leaf
    const void* refs[MAX_REFS];         // normalized references, (B,) each
    const void* policy_params;          // flat (n_pp,), or null
    const void* obs_noise;              // (T, B, n_obs_noise), or null
    const void* proc_noise;             // (T, B, n_proc_noise), or null
    void* y_out[MAX_STATE];
    void* carry_out[MAX_CARRY];
    void* traj_state[MAX_STATE];        // (T / traj_stride, B) per leaf, or null
    void* traj_action[MAX_ACTION];
    void* traj_carry[MAX_CARRY];
    long long batch;
    int n_steps;
    int n_stages;                       // stages evaluated (the FSAL last one is skipped)
    int n_refs;
    int n_carry;
    int n_pp;
    int policy_id;                      // 0 AffineLaw, 1 ActorLaw
    int has_integral;                   // AffineLaw: Ki follows K and b
    int has_clip;                       // AffineLaw
    int deterministic;                  // ActorLaw: no exploration draw
    int n_layers;                       // ActorLaw: hidden layers + head
    int widths[MAX_LAYERS + 1];         // ActorLaw: n_obs, hidden widths..., n_action
    int wrap[MAX_STATE];
    int obs_cols[MAX_OBS];
    int n_obs_noise;
    int noise_idx[MAX_STATE];
    int n_proc_noise;
    int traj_stride;                    // 0: no trajectory saves
    int env_id;
    int fast;                           // the environment's fast_math (FastMath functors and wrap)
};

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return tanh(x); }

// ---------------------------------------------------------------------------
// The counter-hash normal draw of utils/rl_fused.py::_hash_normal
// ---------------------------------------------------------------------------

// murmur3 finalizer (_mix32) on uint32: wrap-around multiplies, logical shifts
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    h ^= h >> 16;
    return h;
}

// Box-Muller over two mixed 24-bit uniforms of (id, t, j, seed).  The
// multipliers are utils/rl_fused.py's signed int32 constants as uint32
// (_KNUTH, _SEED_MUL, _SALT; tests/test_torch_rl_fused.py pins them).
template <typename T>
__device__ __forceinline__ T hash_normal(int id, int t, int j, int seed) {
    const uint32_t h0 = (uint32_t)id * 0x9e3779b1u + ((uint32_t)t + 1u) * 40503u + (uint32_t)(j * 7919)
                        + (uint32_t)seed * 0x85ebca77u;
    const uint32_t u1b = mix32(h0) >> 8;
    const uint32_t u2b = mix32(h0 ^ 0x3c6ef35fu) >> 8;
    const T u1 = (T)(int)u1b * (T)5.9604644775390625e-08 + (T)2.98023223876953125e-08;  // 2**-24, 2**-25
    const T u2 = (T)(int)u2b * (T)5.9604644775390625e-08;
    return dsqrt((T)-2.0 * dlog(u1)) * dcos((T)6.283185307179586 * u2);
}

// ---------------------------------------------------------------------------
// Policy functors: act(args, pp, obs, t, carry, a) with pp the flat
// parameters in shared memory, obs the n_obs observation columns, carry the
// policy carry (updated in place) and a the normalized actions (out).
// ---------------------------------------------------------------------------

// utils/rl_fused.py::make_actor_tile; pp = per layer w (m x n, [i][j]) and
// b (n), then log_std (A), then the float-encoded seed; carry[0] is the
// instance id
struct ActorLaw {
    template <typename T, int A, int MAX_N>
    __device__ __forceinline__ static void act(const ClosedLoopArgs& args, const T* pp, const T* obs, int n_obs, int t,
                               T* carry, T* a) {
        T h[MAX_WIDTH], out[MAX_WIDTH];
        for (int i = 0; i < n_obs; ++i) h[i] = obs[i];
        int off = 0;
        for (int l = 0; l < args.n_layers; ++l) {
            const int m = args.widths[l], n = args.widths[l + 1];
            const T* w = pp + off;
            const T* bias = w + m * n;
            const bool hidden = l < args.n_layers - 1;
            for (int j = 0; j < n; ++j) {
                T acc = bias[j];
                for (int i = 0; i < m; ++i) acc = acc + w[i * n + j] * h[i];
                out[j] = hidden ? dtanh(acc) : acc;
            }
            for (int j = 0; j < n; ++j) h[j] = out[j];
            off += m * n + n;
        }
        const T* log_std = pp + off;
        const int id = (int)carry[0];
        const int seed = (int)pp[off + A];
#pragma unroll
        for (int j = 0; j < A; ++j) {
            T v = h[j];
            if (!args.deterministic) v = v + dexp(log_std[j]) * hash_normal<T>(id, t, j, seed);
            a[j] = clampv(v, T(-1), T(1));
        }
    }
};

// ---------------------------------------------------------------------------
// The closed-loop kernel
// ---------------------------------------------------------------------------

template <typename T, class Env>
__device__ __forceinline__ void postprocess(T* y, const ClosedLoopArgs& args) {
#pragma unroll
    for (int i = 0; i < Env::N_STATE; ++i)
        if (args.wrap[i]) y[i] = Env::Math::wrap(y[i]);
    Env::clip(y);
}

template <typename T, class Env, int NS, class Policy>
__global__ void __launch_bounds__(128) closed_loop_kernel(const __grid_constant__ ClosedLoopArgs args) {
    constexpr int N = Env::N_STATE;
    constexpr int A = Env::N_ACTION;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* pp = reinterpret_cast<T*>(smem_raw);
    const T* pp_src = static_cast<const T*>(args.policy_params);
    for (int i = threadIdx.x; i < args.n_pp; i += blockDim.x) pp[i] = pp_src[i];
    __syncthreads();

    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const long long batch = args.batch;

    const ParamView params{args.param_value, args.param_ptr};
    const typename Env::template Consts<T> k = Env::template prepare<T>(params, b);
    T obs_lo[N];
    Divisor<T> obs_span[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        obs_lo[i] = (T)args.obs_min[i];
        obs_span[i] = divisor(weak_const<T>(args.obs_max[i] - args.obs_min[i]));
    }
    T act_span[A], act_lo[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
        act_span[j] = (T)(args.act_max[j] - args.act_min[j]);
        act_lo[j] = (T)args.act_min[j];
    }
    const int n_obs = N + args.n_refs;
    T obs[MAX_OBS], ref[MAX_REFS];
#pragma unroll
    for (int r = 0; r < MAX_REFS; ++r)
        if (r < args.n_refs) ref[r] = static_cast<const T*>(args.refs[r])[b];

    T y[N], c[MAX_CARRY];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = static_cast<const T*>(args.y0[i])[b];
#pragma unroll
    for (int i = 0; i < MAX_CARRY; ++i)
        if (i < args.n_carry) c[i] = static_cast<const T*>(args.carry0[i])[b];

    const T tau = (T)args.tau;
    const T* obs_noise = static_cast<const T*>(args.obs_noise);
    const T* proc_noise = static_cast<const T*>(args.proc_noise);

    for (int t = 0; t < args.n_steps; ++t) {
        // observation: MinMaxNormalization.normalize per leaf, then the fixed
        // references (rebuilt every step: sensor noise may hit their columns)
#pragma unroll
        for (int i = 0; i < N; ++i) obs[i] = ((T)2 * (y[i] - obs_lo[i])) / obs_span[i] - T(1);
#pragma unroll
        for (int r = 0; r < MAX_REFS; ++r)
            if (r < args.n_refs) obs[N + r] = ref[r];
        if (args.n_obs_noise > 0) {
#pragma unroll
            for (int j = 0; j < MAX_OBS; ++j) {
                if (j < args.n_obs_noise) {
                    const T e = obs_noise[((long long)t * batch + b) * args.n_obs_noise + j];
#pragma unroll
                    for (int i = 0; i < MAX_OBS; ++i)
                        if (args.obs_cols[j] == i) obs[i] = obs[i] + e;
                }
            }
        }
        T a[A];
        Policy::template act<T, A, MAX_OBS>(args, pp, obs, n_obs, t, c, a);

        // MinMaxNormalization.denormalize, then the RK step under the held action
        T u[A];
#pragma unroll
        for (int j = 0; j < A; ++j) u[j] = (a[j] + T(1)) / T(2) * act_span[j] + act_lo[j];
        T ks[NS][N];
        Env::ode(k, y, u, ks[0]);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
            T yi[N];
#pragma unroll
            for (int i = 0; i < N; ++i) yi[i] = lincomb<T, NS, N>(y[i], ks, i, args.a[s], s, tau);
            Env::ode(k, yi, u, ks[s]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) y[i] = lincomb<T, NS, N>(y[i], ks, i, args.b, NS, tau);

        postprocess<T, Env>(y, args);
        if (args.n_proc_noise > 0) {
#pragma unroll
            for (int j = 0; j < MAX_STATE; ++j) {
                if (j < args.n_proc_noise) {
                    const T e = proc_noise[((long long)t * batch + b) * args.n_proc_noise + j];
#pragma unroll
                    for (int i = 0; i < N; ++i)
                        if (args.noise_idx[j] == i) y[i] = y[i] + e;
                }
            }
            postprocess<T, Env>(y, args);
        }
        if (args.traj_stride > 0 && (t + 1) % args.traj_stride == 0) {
            const long long slot = ((t + 1) / args.traj_stride - 1) * batch + b;
#pragma unroll
            for (int i = 0; i < N; ++i) static_cast<T*>(args.traj_state[i])[slot] = y[i];
#pragma unroll
            for (int j = 0; j < A; ++j) static_cast<T*>(args.traj_action[j])[slot] = a[j];
#pragma unroll
            for (int i = 0; i < MAX_CARRY; ++i)
                if (i < args.n_carry) static_cast<T*>(args.traj_carry[i])[slot] = c[i];
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) static_cast<T*>(args.y_out[i])[b] = y[i];
#pragma unroll
    for (int i = 0; i < MAX_CARRY; ++i)
        if (i < args.n_carry) static_cast<T*>(args.carry_out[i])[b] = c[i];
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;

template <typename T, class Env, int NS, class Policy>
static void launch_one(const ClosedLoopArgs& args, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((args.batch + THREADS - 1) / THREADS);
    const size_t smem = (size_t)args.n_pp * sizeof(T);
    closed_loop_kernel<T, Env, NS, Policy><<<blocks, THREADS, smem, stream>>>(args);
}

template <typename T, class Env, class Policy>
static int launch_policy(const ClosedLoopArgs& args, cudaStream_t stream) {
    // the stage counts of the registered explicit solvers (FSAL last stage
    // skipped): Euler 1, Midpoint and Heun 2, RK4 4, Tsit5 and Dopri5 6
    switch (args.n_stages) {
        case 1: launch_one<T, Env, 1, Policy>(args, stream); break;
        case 2: launch_one<T, Env, 2, Policy>(args, stream); break;
        case 4: launch_one<T, Env, 4, Policy>(args, stream); break;
        case 6: launch_one<T, Env, 6, Policy>(args, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T, class Env>
static int launch_env(const ClosedLoopArgs& args, cudaStream_t stream) {
    switch (args.policy_id) {
        case 0: return launch_policy<T, Env, AffineLaw>(args, stream);
        case 1: return launch_policy<T, Env, ActorLaw>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_dtype(const ClosedLoopArgs& args, cudaStream_t stream) {
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

extern "C" int closed_loop_args_size() { return (int)sizeof(ClosedLoopArgs); }

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
extern "C" int closed_loop_launch(const ClosedLoopArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    if (args->n_pp > MAX_POLICY_PARAMS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
