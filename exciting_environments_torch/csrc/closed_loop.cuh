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
//   u   = (a + 1) / 2 * (max - min) + min, scaled into the environment's
//         inverter circle where it has one (act_constrain, svm_limit), the
//         RK step under u;
//   wrap angles and clip; + the process-noise row on noise_idx, wrap/clip;
//   every traj_stride steps save state, normalized action and carry.
//
// The policy.  Pallas traces any Python function into the kernel; a CUDA
// kernel cannot, so the policy families the library's users run are compiled
// in as functors (ops/policies.py holds their plain versions):
//   * the affine law a_j = b_j + sum_i K[j][i] obs_i, optionally a carried
//     integrator c_j += sum_i Ki[j][i] obs_i added to a_j, and a clamp (the
//     PD and PI tracking laws): AffineReg<NOBS> at a compile-time
//     observation width, AffineGeneric (AffineLaw of policy_laws.cuh) at any;
//   * the PPO actor of utils/rl_fused.py, a tanh MLP with a linear head, plus
//     exp(log_std_j) * z with z a counter-hash normal draw of (instance id,
//     step, action dim, seed), clamped to [-1, 1]: ActorReg<H1, H2> at
//     compile-time hidden widths, ActorLaw at run-time ones (policy_laws.cuh,
//     shared with pmsm_closed_loop.cu);
//   * the drive-control tiles of utils/foc.py (foc_laws.cuh), compiled for
//     their own machine only (in its unit, closed_loop/<environment>.cu,
//     through launch_env_dtype's Tiles): the induction machine's
//     field-oriented law on the true state (FocTile) and behind a stationary
//     Kalman flux observer (SensorlessFocTile, eight carry planes), and the
//     EESM's current PIs (EesmCurrentTile); the two FOC tiles also read
//     each drive's speed, torque setpoint and observer gains from per-drive
//     planes (FocDriveTile, SensorlessFocDriveTile).
// Their parameters arrive as one flat vector that each block copies into
// shared memory once (the counterpart of the TPU's SMEM scalar path).  The
// wrapper picks the instantiation (args.variant, ops/kernels/closed_loop.py::
// kernel_variant): AffineReg at NOBS = N + n_refs for n_refs 0 or 1 and
// ActorReg<16, 16> (the actor utils/rl_fused.py builds by default) where the
// policy fits them, the generic functors otherwise.
//
// What bounds it on an H100: operations.  Without saves or noise the kernel
// streams nothing: each instance reads its state, references and
// parameters once and writes its final state once, and in between it does
// a few dozen float32 operations per step (PD/PI laws) or a few hundred (the
// actor, 2 x 16 x 16 multiply-adds plus tanh and the hash).  With saves
// every step (collection) the saves add 4 x (N + A + carry) bytes per step
// and instance.  In fact one dependent chain per instance at 15.5 warps per
// SM sets the time: the kernel runs at a small multiple of the issue time
// of its SASS per step (chip_smoke.py's anatomy, PERF.md section 6).
//
// What the design does about it: one thread per instance keeps the state,
// the policy carry and the observation in registers for all T steps, and
// everything that does not change along the rollout is taken out of the
// loop and pinned in registers (keep()): the tableau in the working type
// with its zero and unit masks (a per-step lincomb over the tableau's
// doubles made the compiler re-derive them every step), the step size, the
// normalization bounds, the wrap mask, and the noise feeds (which noise
// columns land on each observation column and state leaf, as bit masks, so
// that no register array is indexed at run time and no step compares
// against obs_cols or noise_idx).  AffineReg loads K, b and Ki once into
// registers and unrolls the sums at its width, so no step reads shared
// memory or tests a run-time width.  ActorReg keeps its activations in
// register arrays (ActorLaw's run-time widths put them in local memory)
// and reads the weights from shared memory as 16-byte vectors, four
// outputs j..j+3 of one input i at a time: every output keeps its own sum
// in its own order.  Noise slabs are read time-major (T, B, n) and saves
// written time-major (n_saves, B), so neighbouring threads touch
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
// (args.fast, the JAX kernel's fast_wrap) the Pendulum, CartPole and Acrobot
// functors take the FastMath policy of classic_envs.cuh and the wrap is
// wrap_angle_fast.
//
// The build.  Eight environment functors (eleven with the fast-math ones)
// x 2 working types x 4 stage counts x 5 policy instantiations make 440
// kernels, and the machines' tiles 40 more (32 on the induction machine, 8
// on the EESM); each environment's are a translation unit of their own
// (closed_loop/<environment>.cu), compiled in parallel and linked with
// closed_loop.cu's entry point into one library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "classic_envs.cuh"
#include "eager_rules.cuh"
#include "foc_laws.cuh"
#include "policy_laws.cuh"

#define MAX_STAGES 7
#define MAX_STATE 4
#define MAX_ACTION 3
#define MAX_PARAMS 9
#define MAX_REFS 4
#define MAX_OBS (MAX_STATE + MAX_REFS)
#define MAX_CARRY 8
#define MAX_POLICY_PARAMS 4096
#define MAX_POLICY_PLANES 16

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
    double svm_limit;                  // inverter circle radius on actions 0 and 1 (svm_circle), 0: none
    double clip;                       // affine law's clamp bound (with has_clip)
    double frame_step;                 // FOC tiles: omega * tau, the fallback frame's angle per step
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
    int policy_id;                      // 0 affine law, 1 actor, 4 FOC, 5 sensorless FOC, 6 EESM current
    int has_integral;                   // affine law: Ki follows K and b
    int has_clip;                       // affine law
    int deterministic;                  // actor: no exploration draw
    int n_layers;                       // actor: hidden layers + head
    int widths[MAX_LAYERS + 1];         // actor: n_obs, hidden widths..., n_action
    int wrap[MAX_STATE];
    int obs_cols[MAX_OBS];
    int n_obs_noise;
    int noise_idx[MAX_STATE];
    int n_proc_noise;
    int traj_stride;                    // 0: no trajectory saves
    int env_id;
    int fast;                           // the environment's fast_math (FastMath functors and wrap)
    int variant;                        // the policy's instantiation (V_* below)
    // appended after every earlier field, whose offsets stay as they were
    const void* policy_planes[MAX_POLICY_PLANES];  // per-drive policy constants, (B,) each
    int n_planes;
};

// The policy instantiations, in the order of ops/kernels/closed_loop.py::VARIANTS;
// the drive-control tiles (4-6) carry their own, Tile::VARIANT
enum { V_AFFINE = 0, V_AFFINE_GENERIC = 1, V_ACTOR_16_16 = 2, V_ACTOR_GENERIC = 3 };

// ---------------------------------------------------------------------------
// Policy functors.  N_CARRY is the size of the kernel's carry register array;
// prepare(args, pp, carry) runs once per thread before the loop and returns
// what the functor keeps in registers; act(p, args, pp, obs, n_obs, t,
// carry, a) maps the observation registers obs (n_obs columns) to the A
// normalized actions a and updates the carry in place.  pp is the flat
// parameter vector in shared memory.
// ---------------------------------------------------------------------------

// ops/policies.py::AffinePolicy at the compile-time observation width NOBS;
// pp = K (A x NOBS), b (A), [Ki (A x NOBS)], loaded once into registers
template <int NOBS>
struct AffineReg {
    static constexpr int N_CARRY = 4;
    template <typename T, int A>
    struct Prepared {
        T K[A][NOBS], b[A], Ki[A][NOBS];
        T lo, hi;
        unsigned integral, clip;
    };
    template <typename T, int A>
    __device__ __forceinline__ static Prepared<T, A> prepare(const ClosedLoopArgs& args, const T* pp, const T*) {
        Prepared<T, A> p;
        p.integral = args.has_integral != 0;
        p.clip = args.has_clip != 0;
        p.lo = (T)(-args.clip);
        p.hi = (T)args.clip;
#pragma unroll
        for (int j = 0; j < A; ++j) {
            p.b[j] = pp[A * NOBS + j];
            keep(p.b[j]);
#pragma unroll
            for (int i = 0; i < NOBS; ++i) {
                p.K[j][i] = pp[j * NOBS + i];
                p.Ki[j][i] = p.integral ? pp[A * NOBS + A + j * NOBS + i] : T(0);
                keep(p.K[j][i]);
                keep(p.Ki[j][i]);
            }
        }
        keep(p.lo);
        keep(p.hi);
        keep(p.integral);
        keep(p.clip);
        return p;
    }
    // bias first, then the columns in ascending order; then the carry, then
    // the add; then the clamp: AffinePolicy.forward's order
    template <typename T, int A, int NO>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const ClosedLoopArgs&, const T*,
                                               const T (&obs)[NO], int, int, T* carry, T (&a)[A]) {
        static_assert(NOBS <= NO, "the observation registers hold the law's columns");
#pragma unroll
        for (int j = 0; j < A; ++j) {
            T acc = p.b[j];
#pragma unroll
            for (int i = 0; i < NOBS; ++i) acc = acc + p.K[j][i] * obs[i];
            if (p.integral) {
                T c = carry[j];
#pragma unroll
                for (int i = 0; i < NOBS; ++i) c = c + p.Ki[j][i] * obs[i];
                carry[j] = c;
                acc = acc + c;
            }
            if (p.clip) acc = clampv(acc, p.lo, p.hi);
            a[j] = acc;
        }
    }
};

// AffinePolicy at a run-time width: AffineLaw of policy_laws.cuh, which
// reads the gains from shared memory
struct AffineGeneric {
    static constexpr int N_CARRY = 4;
    template <typename T, int A>
    struct Prepared {};
    template <typename T, int A>
    __device__ __forceinline__ static Prepared<T, A> prepare(const ClosedLoopArgs&, const T*, const T*) {
        return {};
    }
    template <typename T, int A, int NO>
    __device__ __forceinline__ static void act(const Prepared<T, A>&, const ClosedLoopArgs& args, const T* pp,
                                               const T (&obs)[NO], int n_obs, int t, T* carry, T (&a)[A]) {
        AffineLaw::template act<T, A, NO>(args, pp, obs, n_obs, t, carry, a);
    }
};

// ---------------------------------------------------------------------------
// The closed-loop kernel
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;

template <class Env, typename T>
__device__ __forceinline__ void postprocess(T* y, unsigned wrap) {
#pragma unroll
    for (int i = 0; i < Env::N_STATE; ++i)
        if ((wrap >> i) & 1u) y[i] = Env::Math::wrap(y[i]);
    Env::clip(y);
}

template <typename T, class Env, int NS, class Policy>
__global__ void __launch_bounds__(THREADS) closed_loop_kernel(const __grid_constant__ ClosedLoopArgs args) {
    constexpr int N = Env::N_STATE;
    constexpr int A = Env::N_ACTION;
    constexpr int NO = N + MAX_REFS;  // observation registers: the state, then the references
    constexpr int NC = Policy::N_CARRY;
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
        keep(obs_lo[i]);
        keep(obs_span[i].v);
    }
    T act_span[A], act_lo[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
        act_span[j] = (T)(args.act_max[j] - args.act_min[j]);
        act_lo[j] = (T)args.act_min[j];
        keep(act_span[j]);
        keep(act_lo[j]);
    }
    const int n_refs = args.n_refs, n_carry = args.n_carry;
    const int n_obs = N + n_refs;
    T ref[MAX_REFS];
#pragma unroll
    for (int r = 0; r < MAX_REFS; ++r) ref[r] = r < n_refs ? static_cast<const T*>(args.refs[r])[b] : T(0);

    T y[N], c[NC];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = static_cast<const T*>(args.y0[i])[b];
#pragma unroll
    for (int i = 0; i < NC; ++i) c[i] = i < n_carry ? static_cast<const T*>(args.carry0[i])[b] : T(0);

    T tau = (T)args.tau;
    keep(tau);
    // the inverter circle (an environment with two or more actions)
    const bool svm = A >= 2 && args.svm_limit > 0.0;
    T svm_lim = (T)args.svm_limit;
    if constexpr (A >= 2) keep(svm_lim);
    const Tableau<T, NS> tb = tableau<T, NS>(args.a, args.b);
    unsigned wrap = 0u;
#pragma unroll
    for (int i = 0; i < N; ++i) wrap |= (unsigned)(args.wrap[i] != 0) << i;
    keep(wrap);
    // which noise columns feed each observation column and each state leaf
    // (bit j: column j of the slab's row), in the slab's column order
    const int n_obs_noise = args.n_obs_noise, n_proc_noise = args.n_proc_noise;
    unsigned obs_feed[NO], proc_feed[N];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
        obs_feed[i] = 0u;
#pragma unroll
        for (int j = 0; j < MAX_OBS; ++j) obs_feed[i] |= (unsigned)(j < n_obs_noise && args.obs_cols[j] == i) << j;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        proc_feed[i] = 0u;
#pragma unroll
        for (int j = 0; j < MAX_STATE; ++j)
            proc_feed[i] |= (unsigned)(j < n_proc_noise && args.noise_idx[j] == i) << j;
    }
    const T* __restrict__ obs_noise = static_cast<const T*>(args.obs_noise) + b * n_obs_noise;
    const T* __restrict__ proc_noise = static_cast<const T*>(args.proc_noise) + b * n_proc_noise;
    const long long obs_noise_step = batch * n_obs_noise, proc_noise_step = batch * n_proc_noise;
    const int traj_stride = args.traj_stride;
    const bool saves = traj_stride > 0;
    int until_save = traj_stride;
    long long save_at = b;

    const auto pol = Policy::template prepare<T, A>(args, pp, c);

    for (int t = 0; t < args.n_steps; ++t) {
        // observation: MinMaxNormalization.normalize per leaf, then the fixed
        // references (rebuilt every step: sensor noise may hit their columns)
        T obs[NO];
#pragma unroll
        for (int i = 0; i < N; ++i) obs[i] = ((T)2 * (y[i] - obs_lo[i])) / obs_span[i] - T(1);
#pragma unroll
        for (int r = 0; r < MAX_REFS; ++r) obs[N + r] = ref[r];
        if (n_obs_noise > 0) {
            // per column, its noise columns in their order
#pragma unroll
            for (int i = 0; i < NO; ++i) {
#pragma unroll
                for (int j = 0; j < MAX_OBS; ++j)
                    if ((obs_feed[i] >> j) & 1u) obs[i] = obs[i] + __ldg(obs_noise + j);
            }
            obs_noise += obs_noise_step;
        }
        T a[A];
        Policy::template act<T, A, NO>(pol, args, pp, obs, n_obs, t, c, a);

        // MinMaxNormalization.denormalize, the environment's inverter circle
        // (act_constrain), then the RK step under the held action
        T u[A];
#pragma unroll
        for (int j = 0; j < A; ++j) u[j] = (a[j] + T(1)) / T(2) * act_span[j] + act_lo[j];
        if constexpr (A >= 2)
            if (svm) svm_circle(u[0], u[1], svm_lim);
        T ks[NS][N];
        Env::ode(k, y, u, ks[0]);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
            T yi[N];
#pragma unroll
            for (int i = 0; i < N; ++i)
                yi[i] = lincomb_masked<T, NS, N>(y[i], ks, i, tb.a[s], tb.a_nz[s], tb.a_one[s], s, tau);
            Env::ode(k, yi, u, ks[s]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) y[i] = lincomb_masked<T, NS, N>(y[i], ks, i, tb.b, tb.b_nz, tb.b_one, NS, tau);

        postprocess<Env>(y, wrap);
        if (n_proc_noise > 0) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int j = 0; j < MAX_STATE; ++j)
                    if ((proc_feed[i] >> j) & 1u) y[i] = y[i] + __ldg(proc_noise + j);
            }
            proc_noise += proc_noise_step;
            postprocess<Env>(y, wrap);
        }
        if (saves && --until_save == 0) {
            until_save = traj_stride;
#pragma unroll
            for (int i = 0; i < N; ++i) static_cast<T*>(args.traj_state[i])[save_at] = y[i];
#pragma unroll
            for (int j = 0; j < A; ++j) static_cast<T*>(args.traj_action[j])[save_at] = a[j];
#pragma unroll
            for (int i = 0; i < NC; ++i)
                if (i < n_carry) static_cast<T*>(args.traj_carry[i])[save_at] = c[i];
            save_at += batch;
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) static_cast<T*>(args.y_out[i])[b] = y[i];
#pragma unroll
    for (int i = 0; i < NC; ++i)
        if (i < n_carry) static_cast<T*>(args.carry_out[i])[b] = c[i];
}

// ---------------------------------------------------------------------------
// Launchers (the plain C entry point is in closed_loop.cu)
// ---------------------------------------------------------------------------

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

// The instantiation the wrapper asked for; a request the policy does not fit
// (family, width) is refused, never widened.  Tiles: the drive-control tiles
// compiled for this environment (the wrapper pairs them, KernelPolicy.env_ids)
template <typename T, class Env, class... Tiles>
static int launch_env(const ClosedLoopArgs& args, cudaStream_t stream) {
    constexpr int N = Env::N_STATE;
    const bool affine = args.policy_id == 0, actor = args.policy_id == 1;
    switch (args.variant) {
        case V_AFFINE:
            if (affine && args.n_refs == 0) return launch_policy<T, Env, AffineReg<N>>(args, stream);
            if (affine && args.n_refs == 1) return launch_policy<T, Env, AffineReg<N + 1>>(args, stream);
            return (int)cudaErrorInvalidValue;
        case V_AFFINE_GENERIC:
            return affine ? launch_policy<T, Env, AffineGeneric>(args, stream) : (int)cudaErrorInvalidValue;
        case V_ACTOR_16_16:
            if (actor && args.n_layers == 3 && args.widths[1] == 16 && args.widths[2] == 16)
                return launch_policy<T, Env, ActorReg<16, 16>>(args, stream);
            return (int)cudaErrorInvalidValue;
        case V_ACTOR_GENERIC:
            return actor ? launch_policy<T, Env, ActorLaw>(args, stream) : (int)cudaErrorInvalidValue;
        default: {
            int rc = (int)cudaErrorInvalidValue;
            (void)((args.variant == Tiles::VARIANT && (rc = launch_policy<T, Env, Tiles>(args, stream), true)) ||
                   ...);
            return rc;
        }
    }
}

// The instantiations of one environment functor in both working types
template <class Env, class... Tiles>
static int launch_env_dtype(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return dtype == 0 ? launch_env<float, Env, Tiles...>(args, stream) : launch_env<double, Env, Tiles...>(args, stream);
}

// One translation unit per environment, closed_loop/<environment>.cu, compiled in
// parallel and linked into one library with closed_loop.cu's entry point
int closed_loop_pendulum(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_mass_spring_damper(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_cart_pole(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_van_der_pol(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_fluid_tank(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_acrobot(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_induction_machine(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
int closed_loop_eesm(const ClosedLoopArgs& args, int dtype, cudaStream_t stream);
