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
// What bounds it on an H100: by the roofline, the action slab.  Each
// instance streams T * A action values once; the state is a handful of
// registers.  At the main size (pendulum, B = 65,536, T = 4,096, float32)
// that is 1.07 GB, or 0.32 ms at 3.35 TB/s, against a few dozen float32
// operations per step and instance.  What bounds it in fact is the chain of
// dependent instructions of one step: one thread per instance gives 15.5
// warps per SM (4 per scheduler) and nothing else to overlap, so the kernel
// takes about 1.9 times the issue time of its ~100 SASS instructions per
// step (chip_smoke.py's anatomy; PERF.md section 6).  The first version of
// this kernel was bound by latency instead: one dependent 4-byte load per
// step (the slab could alias the trajectory stores, so no load was issued
// ahead) kept some 2 KB per SM in flight where 3.35 TB/s needs about 25 KB,
// beside a run-time division for the action row every step.
//
// What the design does about it: one thread per instance keeps its state
// in registers for all T steps, and the block stages its 128 instances'
// actions through a ring of STAGES shared-memory tiles of K rows, filled
// with cp.async two tiles ahead of the rows being integrated: 16 KB per
// block in flight, 64 KB per SM at four blocks, so no step waits on device
// memory.  A tile is copied in 16-byte pieces where the slab's lines allow
// it (else one action vector per piece), the ragged edge zero-filled, from
// either layout: a time-major tile is K rows of 128 * A contiguous values,
// a batch-major one 128 rows of K * A, so a batch-major slab needs no
// transposed copy.  Each thread reads its own column from shared memory.
// The ring's pieces (Ring, tile_copy, issue_tile, cp.async) live in
// action_ring.cuh, shared with the fast pendulum (pendulum_fast.cu).
// The loop advances the action row with a counter (no division), reads the
// next row for use_next stages from the ring (the next tile is waited for
// when a stage needs it), keeps the tableau's weights and zero/unit masks,
// the step size and the slot offsets in registers (keep()), and wraps
// angles through floored_mod's exact fast path (eager_rules.cuh).  The
// denormalization of the action is folded into the kernel; an action held
// for R solver steps is denormalized once.  The TPU kernel's (8, 128)
// tiles, VMEM chunk budgets and revisited output blocks have no
// counterpart; any batch size works.
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
// trigonometry, Pendulum, CartPole and Acrobot, have fast instantiations.
// The induction machine's and the EESM's inverter limit (svm_circle of
// classic_envs.cuh, args.svm_limit) scales the denormalized action, where
// the JAX package applies env._constrained_phys_action to the slab before
// its launch (env_fused_rollout, env_fused_sim_ahead).  Each environment's
// instantiations (2 working types x 7 stage counts, x 2 with fast math) are
// a translation unit of their own (stepper/<environment>.cu), compiled in
// parallel and linked with stepper.cu's entry point into one library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "action_ring.cuh"
#include "classic_envs.cuh"
#include "eager_rules.cuh"

#define MAX_STAGES 7
#define MAX_STATE 4
#define MAX_ACTION 3
#define MAX_PARAMS 9

// Mirrored field for field by StepperArgs in ops/kernels/stepper.py.
struct StepperArgs {
    double tau;
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double param_value[MAX_PARAMS];    // scalar parameter (param_ptr null)
    double act_min_value[MAX_ACTION];  // scalar normalization bound (ptr null)
    double act_max_value[MAX_ACTION];
    double svm_limit;                  // inverter circle radius on actions 0 and 1 (svm_circle), 0: none
    const void* param_ptr[MAX_PARAMS];  // per-batch parameter (B,), or null
    const void* act_min_ptr[MAX_ACTION];
    const void* act_max_ptr[MAX_ACTION];
    const void* y0[MAX_STATE];          // (B,) per state leaf
    void* y_out[MAX_STATE];             // (B,) per state leaf
    void* traj[MAX_STATE];              // (T / traj_stride, B) per leaf, or null
    const void* actions;                // normalized, (T / hold, B, A), or (B, T / hold, A) with batch_major
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
    int batch_major;                    // layout of the action slab
};

// ---------------------------------------------------------------------------
// The action ring
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;  // instances per block
static constexpr int STAGES = 3;     // tiles in the ring: the one being read and two in flight
static constexpr int TILE_BYTES = 64;  // bytes of one instance's actions per tile

template <typename T, int A>
using StepRing = Ring<T, A, THREADS, TILE_BYTES>;  // action_ring.cuh

// ---------------------------------------------------------------------------
// The rollout kernel
// ---------------------------------------------------------------------------

template <class Env, typename T>
__device__ __forceinline__ void postprocess(T* y, unsigned wrap) {
#pragma unroll
    for (int i = 0; i < Env::N_STATE; ++i)
        if ((wrap >> i) & 1u) y[i] = Env::Math::wrap(y[i]);
    Env::clip(y);
}

template <typename T, class Env, int NS>
__global__ void __launch_bounds__(THREADS) stepper_kernel(const __grid_constant__ StepperArgs args) {
    constexpr int N = Env::N_STATE;
    constexpr int A = Env::N_ACTION;
    using R = StepRing<T, A>;
    __shared__ __align__(16) T ring[STAGES * R::SLOT];

    const long long batch = args.batch;
    const long long b0 = (long long)blockIdx.x * THREADS;
    const long long b = b0 + threadIdx.x;
    const bool active = b < batch;
    const long long bl = active ? b : batch - 1;  // an idle thread of the ragged block reads a real instance

    const ParamView params{args.param_value, args.param_ptr};
    const typename Env::template Consts<T> k = Env::template prepare<T>(params, bl);
    T span[A], lo[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
        const Weak<T> mn = weak_load<T>(args.act_min_ptr[j], args.act_min_value[j], bl);
        const Weak<T> mx = weak_load<T>(args.act_max_ptr[j], args.act_max_value[j], bl);
        span[j] = value(wsub(mx, mn));
        lo[j] = value(mn);
    }
    T y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = static_cast<const T*>(args.y0[i])[bl];

    T tau = (T)args.tau;
    keep(tau);
    // the inverter circle (an environment with two or more actions)
    const bool svm = A >= 2 && args.svm_limit > 0.0;
    T svm_lim = (T)args.svm_limit;
    if constexpr (A >= 2) keep(svm_lim);
    const Tableau<T, NS> tb = tableau<T, NS>(args.a, args.b);
    unsigned wrap = 0u, use_next = 0u;
#pragma unroll
    for (int i = 0; i < N; ++i) wrap |= (unsigned)(args.wrap[i] != 0) << i;
#pragma unroll
    for (int s = 0; s < NS; ++s) use_next |= (unsigned)(args.use_next[s] != 0) << s;
    const bool has_next = use_next != 0u;
    const bool step_mode = !args.sim_ahead;
    // which noise columns feed each state leaf (bit j of feed[i]), so that
    // the loop indexes no register array
    const int n_noise = args.n_noise;
    unsigned feed[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        feed[i] = 0u;
#pragma unroll
        for (int j = 0; j < MAX_STATE; ++j) feed[i] |= (unsigned)(j < n_noise && args.noise_idx[j] == i) << j;
    }
    const T* __restrict__ noise = static_cast<const T*>(args.noise) + bl * n_noise;
    const long long noise_step = batch * n_noise;
    const int traj_stride = args.traj_stride;
    const bool saves = traj_stride > 0;
    int until_save = traj_stride;
    long long save_at = bl;

    // the ring: tiles 0 and 1 in flight before the loop, tile + 2 issued
    // when tile is read
    const T* __restrict__ slab = static_cast<const T*>(args.actions);
    const int hold = args.hold;
    const int n_rows = args.n_steps / hold;
    const int n_tiles = (n_rows + R::K - 1) / R::K;
    const bool batch_major = args.batch_major != 0;
    const long long row_elems = batch_major ? (long long)n_rows * A : batch * A;
    // 16-byte pieces where every line starts on a 16-byte boundary, else one
    // action vector (A elements) per piece
    const bool vec16 = ring_vec16(slab, row_elems);
    const TileCopy copy = tile_copy<R>(vec16 ? 16 / (int)sizeof(T) : R::E1, b0, batch, n_rows, batch_major);
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            T* slot = ring + (tile % STAGES) * R::SLOT;
            if (vec16)
                issue_tile<R, 16>(slot, slab, copy, tile, b0, batch, n_rows, batch_major);
            else
                issue_tile<R, R::E1 * (int)sizeof(T)>(slot, slab, copy, tile, b0, batch, n_rows, batch_major);
        }
        cp_async_commit();
    };
#pragma unroll 1
    for (int tile = 0; tile < STAGES - 1; ++tile) issue(tile);
    // this thread's column of a slot: element (row, a) at col + row * row_step + a
    const int col = batch_major ? threadIdx.x * (R::KA + R::PAD) : threadIdx.x * A;
    const int row_step = batch_major ? A : THREADS * A;

    for (int tile = 0; tile < n_tiles; ++tile) {
        if (has_next)
            cp_async_wait<0>();  // a stage reads the first row of the next tile
        else
            cp_async_wait<1>();
        __syncthreads();
        issue(tile + 2);  // into the slot of tile - 1, which every thread has finished

        // this thread's column in the tile's slot and in the next one's,
        // computed once per tile (not once per row)
        unsigned cur = (tile % STAGES) * R::SLOT + col;
        unsigned nxt = ((tile + 1) % STAGES) * R::SLOT + col;
        keep(cur);
        keep(nxt);
        // do-while loops: a tile has at least one row, a row at least one step
        const int rows = min(R::K, n_rows - tile * R::K);
        int r = 0;
        do {
            // MinMaxNormalization.denormalize: (x + 1) / 2 * (max - min) + min
            // then the environment's inverter circle on the physical action
            T u[A], un[A];
#pragma unroll
            for (int j = 0; j < A; ++j) u[j] = (ring[cur + r * row_step + j] + T(1)) / T(2) * span[j] + lo[j];
            if constexpr (A >= 2)
                if (svm) svm_circle(u[0], u[1], svm_lim);
            if (has_next) {
                // the next action row: in this tile, the next one's first, or
                // this row again at the end of the horizon
                const unsigned p = tile * R::K + r + 1 >= n_rows ? cur + r * row_step
                                                                 : (r + 1 < R::K ? cur + (r + 1) * row_step : nxt);
#pragma unroll
                for (int j = 0; j < A; ++j) un[j] = (ring[p + j] + T(1)) / T(2) * span[j] + lo[j];
                if constexpr (A >= 2)
                    if (svm) svm_circle(un[0], un[1], svm_lim);
            }
            int h = 0;
            do {
                const bool last = h == hold - 1;  // only the row's last step sees the next row
                T ks[NS][N];
                Env::ode(k, y, u, ks[0]);
#pragma unroll
                for (int s = 1; s < NS; ++s) {
                    T yi[N], us[A];
#pragma unroll
                    for (int i = 0; i < N; ++i)
                        yi[i] = lincomb_masked<T, NS, N>(y[i], ks, i, tb.a[s], tb.a_nz[s], tb.a_one[s], s, tau);
#pragma unroll
                    for (int j = 0; j < A; ++j) us[j] = (last && ((use_next >> s) & 1u)) ? un[j] : u[j];
                    Env::ode(k, yi, us, ks[s]);
                }
#pragma unroll
                for (int i = 0; i < N; ++i)
                    y[i] = lincomb_masked<T, NS, N>(y[i], ks, i, tb.b, tb.b_nz, tb.b_one, NS, tau);

                if (step_mode) {
                    postprocess<Env>(y, wrap);
                    if (n_noise > 0) {
                        // per leaf, its noise columns in their order
#pragma unroll
                        for (int i = 0; i < N; ++i) {
#pragma unroll
                            for (int j = 0; j < MAX_STATE; ++j)
                                if ((feed[i] >> j) & 1u) y[i] = y[i] + __ldg(noise + j);
                        }
                        noise += noise_step;
                        postprocess<Env>(y, wrap);
                    }
                }
                if (saves && --until_save == 0) {
                    until_save = traj_stride;
                    if (active) {
#pragma unroll
                        for (int i = 0; i < N; ++i) static_cast<T*>(args.traj[i])[save_at] = y[i];
                    }
                    save_at += batch;
                }
            } while (++h < hold);
        } while (++r < rows);
    }
    cp_async_wait<0>();
    if (active) {
#pragma unroll
        for (int i = 0; i < N; ++i) static_cast<T*>(args.y_out[i])[b] = y[i];
    }
}

// ---------------------------------------------------------------------------
// Launchers (the plain C entry point is in stepper.cu)
// ---------------------------------------------------------------------------

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

// The instantiations of one environment functor in both working types
template <class Env>
static int launch_env_dtype(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return dtype == 0 ? launch_env<float, Env>(args, stream) : launch_env<double, Env>(args, stream);
}

// One translation unit per environment, stepper/<environment>.cu, compiled in
// parallel and linked into one library with stepper.cu's entry point
int stepper_pendulum(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_mass_spring_damper(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_cart_pole(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_van_der_pol(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_fluid_tank(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_acrobot(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_induction_machine(const StepperArgs& args, int dtype, cudaStream_t stream);
int stepper_eesm(const StepperArgs& args, int dtype, cudaStream_t stream);
