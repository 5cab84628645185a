// Closed-loop rollout of the PMSM drive with the policy inside the kernel:
// every step builds the observation from the drive state, evaluates the
// policy, constrains its action into the inverter hexagon, swaps the
// deadtime buffer and takes the RK step of the currents over the magnetics
// table, for the whole horizon of T steps in one launch.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pmsm_stepper.py::
// _make_cl_kernel (launcher _pmsm_cl_launch, constraint _hex_constrain).
// Per step, in this order (the TPU kernel's body):
//   1. torque from the currents (its gather is the first RK stage's);
//   2. obs = normalized i_d, i_q, omega, torque, raw cos/sin eps, normalized
//      buffers, then the normalized references; + the sensor-noise row;
//   3. the scheduled gather (ScheduledLUT) of n_sched maps at the policy's
//      denormalized belief currents (two carry leaves);
//   4. a = policy(obs, sched, t, carry), carry updated;
//   5. u_con = the hexagon constraint of a at the deadtime-advanced angle;
//   6. deadtime 1: the buffer drives the plant and takes u_con; else u_con;
//   7. the RK step of (i_d, i_q); + the process-noise row on the currents;
//   8. eps += tau * rate, wrapped into [-pi, pi).
// Every traj_stride steps it saves the post-step i_d, i_q and torque (the
// torque from the next step's gather, or after the loop), u_con, a and the
// carry; at the end the five state values, the torque, the last applied
// voltage (for an FSAL solver's final carry) and the carry.
//
// The policy families are compiled in as functors (ops/policies.py,
// utils/foc.py and utils/rl_fused.py hold their plain versions): the P
// and PI laws (pmsm_closed_loop/affine.cu: AffineAdapter over policy_laws.cuh's
// AffineLaw, AffineCurrentsReg), SensorlessLaw (a constant-gain
// Kalman current observer and a decoupled PI on its belief, linear
// magnetics), ScheduledLaw (the gain-scheduled observer and PI of the
// saturated drive, which reads the scheduled gather) and ScheduledDriveLaw
// (the same per drive: its references, feedforwards and speed from per-drive
// planes, its own slice of the schedule), in pmsm_closed_loop.cu, and the
// PPO actor (policy_laws.cuh's ActorReg<16, 16>
// for the default hidden widths, ActorLaw at others; the instance id rides
// carry plane 0, t is the step index), in pmsm_closed_loop/actor.cu.  Their
// flat parameters are copied into shared memory once per block, after the
// table, where they start on a 16-byte boundary (the table is a whole
// number of 8-channel points): ActorReg reads its weights as 16-byte
// vectors, AffineCurrentsReg loads its gains from there into registers
// once per thread.
//
// What bounds it on an H100: operations.  Without saves or slabs a drive
// reads its state, parameters and references once and writes its finals
// once; in between each step does a few hundred float32 operations: two
// bilinear gathers of six channels (the torque's, which is also the first
// stage's, and one per further stage), the observation, the policy, two
// sincos pairs and the hexagon.  The sensorless case streams its sensor
// slab, 8 B per step and drive in float32.  In fact the kernel runs at 1.6
// to 2.2 times the issue time of its 515-680 SASS instructions per step
// (chip_smoke.py's anatomy; PERF.md section 6): one dependent chain per
// drive at 15.5 warps per SM, between issue- and latency-bound.
//
// What the design does about it: one thread per drive keeps the state,
// omega and up to six carry leaves in registers for all T steps; the
// observation stays in registers too (the noise columns feeding each
// observation column are a bit mask, so nothing indexes the array).  The
// magnetics table sits in dynamic shared memory channel-interleaved, (nx,
// ny, 8): each corner of a gather is two 16-byte loads from one address
// (ops/lut.py::interleave_channels, 47,488 B for BRUSA in float32, four
// 128-thread blocks per SM).  The scheduled maps (10 channels, 71,232 B
// interleaved to 12) are gathered in three 16-byte loads per corner.  One
// table for the fleet (ScheduledLaw) is read from device memory through the
// read-only data cache; a fleet near its setpoints gathers a few cells,
// which stay in L1.  Per drive (ScheduledDriveLaw) the schedule is one such
// table per distinct speed, one after the other, and a drive gathers from
// its own (args.sched_slices, args.slice_elems); 32 slices are 2.3 MB, which
// a fleet spread over them would read from L2 at every step.  So its launch
// orders the drives by slice once per launch plan (args.perm: thread
// position p serves drive perm[p], a stable sort), sizes the blocks so that
// the fleet is one wave (512 threads, one block an SM at B = 65,536) and
// has each block copy the slices its range spans (args.block_slices, up to
// n_staged of them: two BRUSA slices beside the table, 190 KB) into shared
// memory after the rotations.  A drive whose slice is staged gathers from shared
// memory, any other from device memory as before (many small slices, a slice
// larger than what the table leaves, as in float64, or no tiling).  Each
// drive's arithmetic and table values are the same on either path; only the
// thread that runs it and where its loads come from change.  Per step there is
// one sincosf per distinct angle (the observation's and the hexagon's, with
// cos(-x) == cos(x) and sin(-x) == -sin(x), which the card checked for every
// float32 |x| < 2^7; float64 keeps the literal calls), no fmod loop
// (floored_mod's exact fast path), and the run-time constants (the sector
// rotations in shared memory, the angle's advance and rate, the tableau, the
// step size) are computed once.  Slabs are read time-major (T, B, n) and saves
// written time-major (n_saves, B); any B works (the ragged edge is
// masked).  The TPU kernel's (8, 128) tiles, time chunks, revisited output
// blocks, VMEM budgets, SMEM scalar tree and one-hot gathers have no
// counterpart.
//
// A functor names the observation columns it reads (COLUMNS), and the step
// builds no other.  The affine law has two instantiations.  AffineAdapter
// reads every column, its gains from shared memory each step (held in
// registers they cost the kernel its occupancy: pmsm_closed_loop/affine.cu).
// AffineCurrentsReg reads i_d, i_q, omega and the references, its gains in
// registers, so that a step computes neither the torque (only for a save)
// nor sincosf(eps) nor the buffers' normalizations nor the sensor noise on
// those columns, and the control chain (observation, law, hexagon, the
// deadtime buffer) no longer waits on the torque's gather.  The host picks
// it where every gain of K and Ki on columns 3-7 is zero
// (pmsm_closed_loop.py::kernel_variant, once a launch plan), and the full
// law for gains it cannot read without waiting on the card.  Exact: a
// skipped term is 0 * x with x finite wherever the currents are (the
// torque, cos/sin, the buffers), and adding +-0 to a sum changes it not at
// all, or only the sign of a zero sum; the other terms keep
// AffinePolicy.forward's order.
//
// The build: the kernel and its launchers are this header; pmsm_closed_loop.cu
// instantiates the two sensorless families (12 kernels) and holds the C
// entry points, pmsm_closed_loop/affine.cu the affine law (2 column sets x
// 2 types x 4 stage counts x 2 magnetics = 32 kernels),
// pmsm_closed_loop/actor.cu the actor (2 widths x 2 types x 4 stage counts
// x 2 magnetics = 32 kernels), compiled in parallel and linked into one
// library.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/pmsm_closed_loop.py::plain_pmsm_cl_step with the policies'
// forward) in order and working precision, under PyTorch's CUDA eager rules
// (eager_rules.cuh): a division by a Python number (a scalar band's
// max - min, a grid step) is a multiply by its reciprocal taken in double,
// a division by a per-batch band is a true division, `u_lim / m` is
// reciprocal(m) * u_lim as Tensor.__rtruediv__ computes it, and the
// policies' Python-float constants arrive folded in the flat vector.  Build
// with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "pmsm_drive.cuh"
#include "policy_laws.cuh"

#define MAX_STAGES 7
#define MAX_REFS 4
#define N_BASE_OBS 8
#define MAX_OBS (N_BASE_OBS + MAX_REFS)
#define MAX_CARRY 6
#define MAX_SCHED 10
#define MAX_POLICY_PLANES 5
#define N_BANDS 17
#define MAX_POLICY_PARAMS (2048 + 1)  // the actor's budget (utils/rl_fused.py::MAX_ACTOR_PARAMS) and its seed

// band slots, in the order of PBN_FIELDS in ops/kernels/pmsm_closed_loop.py:
// u_dc, the action bands, then (min, max) of the six observation bands
// (i_d, i_q, omega_el, torque, u_d_buffer, u_q_buffer)
enum { B_UDC = 0, B_AD_MN = 1, B_AD_MX = 2, B_AQ_MN = 3, B_AQ_MX = 4, B_OBS = 5 };

// Mirrored field for field by PmsmClArgs in ops/kernels/pmsm_closed_loop.py.
struct PmsmClArgs {
    double tau;
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double rate_b[MAX_STAGES];         // the full tableau's b, for the angle rate
    double param_value[N_PARAMS];      // scalar parameter (param_ptr null)
    double x0, dx, y0, dy;             // LUT grid (Python numbers)
    double band_value[N_BANDS];        // scalar band (band_ptr null)
    double adv_scale;                  // deadtime + 0.5
    double rot_re[8], rot_im[8];       // ops/transforms.py ROTATION_RE/IM at [b0][b1][b2]
    double clip;                       // AffinePolicy's clamp bound (with has_clip)
    const void* param_ptr[N_PARAMS];   // per-batch parameter (B,), or null
    const void* band_ptr[N_BANDS];     // per-batch band (B,), or null
    const void* lut;                   // (nx, ny, 8) interleaved, saturated only
    const void* sched;                 // (nx, ny, 12) interleaved, or null
    const void* state0[5];             // (B,) i_d, i_q, eps, u_d_buffer, u_q_buffer
    const void* omega;                 // (B,)
    const void* carry0[MAX_CARRY];     // (B,) per policy-carry leaf
    const void* refs[MAX_REFS];        // normalized references, (B,) each
    const void* policy_params;         // flat (n_pp,), or null
    const void* obs_noise;             // (T, B, n_obs_noise), or null
    const void* proc_noise;            // (T, B, n_proc_noise), or null
    void* out[6];                      // (B,) i_d, i_q, eps, u_d_buffer, u_q_buffer, torque
    void* u_last[2];                   // (B,) last applied voltage, or null
    void* carry_out[MAX_CARRY];
    void* traj[7];                     // (n_saves, B) i_d, i_q, torque, u_con_d, u_con_q, a_d, a_q, or null
    void* traj_carry[MAX_CARRY];
    long long batch;
    int nx, ny;
    int n_steps;
    int n_stages;                      // stages evaluated (the FSAL last one is skipped)
    int n_rate;                        // entries of rate_b
    int saturated;
    int deadtime;                      // 0 or 1
    int n_refs;
    int n_carry;
    int n_pp;
    int n_sched;                       // 0 or MAX_SCHED
    int sched_c0, sched_c1;            // carry leaves of the normalized belief currents
    int policy_id;                     // 0 AffinePolicy, 1 the actor, 2 SensorlessLaw, 3 ScheduledLaw or ScheduledDriveLaw
    int has_integral;                  // AffinePolicy: Ki follows K and b
    int has_clip;                      // AffinePolicy
    int delayed;                       // sensorless laws: the applied voltage is last step's command
    int obs_cols[MAX_OBS];
    int n_obs_noise;
    int noise_idx[2];
    int n_proc_noise;
    int traj_stride;                   // 0: no trajectory saves
    // the actor's options, last: the older families' fields keep their offsets
    int deterministic;                 // actor: no exploration draw
    int n_layers;                      // actor: hidden layers + head
    int widths[MAX_LAYERS + 1];        // actor: n_obs, hidden widths..., n_action
    // the per-drive scheduled tile (ScheduledDriveLaw)
    const void* policy_planes[MAX_POLICY_PLANES];  // (B,) REF_D, REF_Q, FF_D, FF_Q, OMEGA, or null
    const void* sched_slices;          // (B,) int32: each drive's slice of sched, or null
    long long slice_elems;             // elements of one slice of sched (nx * ny * 12)
    int n_planes;                      // 0 or MAX_POLICY_PLANES
    int n_slices;                      // slices of sched (0: one table)
    // the staged path of a SLICED functor (ops/kernels/pmsm_closed_loop.py::slice_tiling)
    const void* perm;                  // (B,) int32: thread position p serves drive perm[p], or null
    const void* block_slices;          // (blocks, n_staged) int32: the slices a block stages, -1 for none
    int n_staged;                      // slices a block stages in shared memory (0: none, the global path)
    int block_threads;                 // threads of a block on the staged path (0: THREADS)
    int affine_columns;                // AffinePolicy: COLS_ALL or COLS_CURRENTS (pmsm_closed_loop/affine.cu)
};

// The observation columns a policy functor reads (its COLUMNS): every column,
// or i_d, i_q, omega and the references (columns 0-2 and from N_BASE_OBS on),
// so that a step builds neither the torque nor cos/sin eps nor the buffers
enum { COLS_ALL = 0, COLS_CURRENTS = 1 };

__host__ __device__ constexpr bool column_read(int cols, int i) {
    return cols == COLS_ALL || i < 3 || i >= N_BASE_OBS;
}

// ---------------------------------------------------------------------------
// Policy functors: act(args, pp, obs, n_obs, sv, t, carry, a), with sv the
// scheduled gather's channels, runs per step.  A functor with PREPARES has a
// prepare(args, pp, carry) that runs once per thread before the time loop
// and returns what it keeps in registers, and act takes that first.
// COLUMNS names the observation columns act reads; the kernel builds no other.
// ---------------------------------------------------------------------------

struct Unprepared {};

// A SCHEDULED functor with SLICED gathers its drive's own slice of the
// schedule: its launch may order the drives by slice and stage each block's
// slices in shared memory (the kernel's staged path)
template <class Policy>
__host__ __device__ constexpr bool sliced() {
    if constexpr (Policy::SCHEDULED)
        return Policy::SLICED;
    else
        return false;
}

// Threads of a block: THREADS, or up to SLICED_THREADS on a SLICED functor's
// staged path in float32 (one block an SM; float64 keeps THREADS)
static constexpr int THREADS = 128;
static constexpr int SLICED_THREADS = 512;
template <typename T, class Policy>
struct BlockShape {
    static constexpr int MAX_THREADS = sliced<Policy>() && sizeof(T) == 4 ? SLICED_THREADS : THREADS;
};

template <class Policy, typename T>
__device__ __forceinline__ auto prepare_policy(const PmsmClArgs& args, const T* pp, const T* c) {
    if constexpr (Policy::PREPARES)
        return Policy::template prepare<T>(args, pp, c);
    else
        return Unprepared{};
}

// The scheduled maps a thread gathers from in device memory: the launch's one
// table, or for a SLICED functor its drive's slice (the index its prepare keeps)
template <class Policy, typename T, class Prepared>
__device__ __forceinline__ const T* sched_table(const PmsmClArgs& args, const Prepared& pol) {
    if constexpr (sliced<Policy>())
        return static_cast<const T*>(args.sched) + (long long)pol.slice * args.slice_elems;
    else
        return static_cast<const T*>(args.sched);
}

// The drive at thread position p: p, or on the staged path the drive the
// launch's permutation puts there (a SLICED functor's launch)
__device__ __forceinline__ long long drive_of(const PmsmClArgs& args, long long p) {
    return args.perm != nullptr ? (long long)static_cast<const int*>(args.perm)[p] : p;
}

// The slot of slice s among the slices this block staged, or -1
__device__ __forceinline__ int staged_slot(const PmsmClArgs& args, int s) {
    const int* slots = static_cast<const int*>(args.block_slices) + (long long)blockIdx.x * args.n_staged;
    int slot = -1;
    for (int j = 0; j < args.n_staged; ++j)
        if (__ldg(slots + j) == s) slot = j;
    return slot;
}

// utils/rl_fused.py::ActorPolicy on the drive's observation (eight columns,
// then the references): policy_laws.cuh's ActorReg<16, 16> or ActorLaw with
// A = 2; the instance id is carry plane 0
template <class Law>
struct ActorAdapter {
    static constexpr bool SCHEDULED = false;
    static constexpr bool PREPARES = true;
    static constexpr int COLUMNS = COLS_ALL;
    template <typename T>
    using Prepared = typename Law::template Prepared<T, 2>;
    template <typename T>
    __device__ __forceinline__ static Prepared<T> prepare(const PmsmClArgs& args, const T* pp, const T* c) {
        return Law::template prepare<T, 2>(args, pp, c);
    }
    template <typename T>
    __device__ __forceinline__ static void act(const Prepared<T>& p, const PmsmClArgs& args, const T* pp,
                                               const T (&obs)[MAX_OBS], int n_obs, const T*, int t, T* c,
                                               T (&a)[2]) {
        Law::template act<T, 2, MAX_OBS>(p, args, pp, obs, n_obs, t, c, a);
    }
};

// ---------------------------------------------------------------------------
// Per-instance bands and the hexagon
// ---------------------------------------------------------------------------

// The effective bands of one drive (eff_cl_norms): scalars folded in double
// as Python folds them, per-batch planes in the working type.
template <typename T>
struct Bands {
    T obs_lo[6];
    Divisor<T> obs_span[6];  // 2 * (x - lo) / span
    T obs_dlo[2], obs_dspan[2];  // (c + 1) / 2 * (max - min) + min for i_d, i_q
    T act_lo[2], act_span[2];
    T inv_half_dc;           // 1 / (u_dc / 2)
    T half_dc;               // u_dc / 2
};

template <typename T>
__device__ __forceinline__ Bands<T> bands(const PmsmClArgs& args, long long b) {
    Weak<T> w[N_BANDS];
#pragma unroll
    for (int i = 0; i < N_BANDS; ++i) w[i] = weak_load<T>(args.band_ptr[i], args.band_value[i], b);
    Bands<T> k;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const Weak<T> mn = w[B_OBS + 2 * i], mx = w[B_OBS + 2 * i + 1];
        k.obs_lo[i] = value(mn);
        k.obs_span[i] = divisor(wsub(mx, mn));
        if (i < 2) {
            k.obs_dlo[i] = value(mn);
            k.obs_dspan[i] = value(wsub(mx, mn));
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const Weak<T> mn = w[B_AD_MN + 2 * j], mx = w[B_AD_MX + 2 * j];
        k.act_lo[j] = value(mn);
        k.act_span[j] = value(wsub(mx, mn));
    }
    dc_link(w[B_UDC], k.inv_half_dc, k.half_dc);  // pmsm_drive.cuh
    return k;
}

// 2 * (x - min) / (max - min) - 1
template <typename T>
__device__ __forceinline__ T normalize(const Bands<T>& k, int i, T x) {
    return (T)2 * (x - k.obs_lo[i]) / k.obs_span[i] - T(1);
}

// pmsm_closed_loop.py::hex_constrain (the TPU kernel's _hex_constrain):
// denormalize, rotate to alpha/beta at the deadtime-advanced angle, clip into
// the hexagon with the linear sector test, rotate back.  adv_inc is the
// drive's omega * tau * (deadtime + 0.5); rot the sector rotations (8 real
// parts, then 8 imaginary ones) in the working type.
template <typename T>
__device__ __forceinline__ void hex_constrain(const Bands<T>& k, const T* rot, T a_d, T a_q, T eps, T adv_inc,
                                              T& u_con_d, T& u_con_q) {
    const T u_d = (a_d + T(1)) * (T)0.5 * k.act_span[0] + k.act_lo[0];
    const T u_q = (a_q + T(1)) * (T)0.5 * k.act_span[1] + k.act_lo[1];
    const T nd = u_d * k.inv_half_dc;
    const T nq = u_q * k.inv_half_dc;

    const T adv = advanced_angle(eps, adv_inc);  // pmsm_drive.cuh

    T ca, sa, cb, sb;
    hex_angles(adv, ca, sa, cb, sb);
    const T alpha = ca * nd + sa * nq;
    const T beta = -sa * nd + ca * nq;
    const T s120 = (T)0.8660254037844386;
    const int b0 = beta >= T(0);
    const int b1 = (T)-0.5 * beta - s120 * alpha >= T(0);
    const int b2 = (T)-0.5 * beta + s120 * alpha >= T(0);
    const int idx = b0 * 4 + b1 * 2 + b2;
    const T rot_re = rot[idx], rot_im = rot[8 + idx];
    T ra = alpha * rot_re - beta * rot_im;
    T rb = alpha * rot_im + beta * rot_re;
    ra = clampv(ra, (T)(-2.0 / 3.0), (T)(2.0 / 3.0));
    rb = clampv(rb, T(0), (T)(2.0 / 3.0 * 1.7320508075688772));
    const T oa = ra * rot_re + rb * rot_im;
    const T ob = rb * rot_re - ra * rot_im;

    u_con_d = (cb * oa + sb * ob) * k.half_dc;
    u_con_q = (-sb * oa + cb * ob) * k.half_dc;
}

// ---------------------------------------------------------------------------
// The closed-loop kernel
// ---------------------------------------------------------------------------

// channels of the interleaved scheduled maps (ops/lut.py::padded_channels)
#define MAX_SCHED_PAD 12

// Dynamic shared memory of one block, in elements of T: the interleaved
// magnetics table (16-byte aligned, first), the policy's flat parameters,
// the 16 sector rotations and, on the staged path, the block's slices of the
// schedule (16-byte aligned, slot after slot).
__host__ __device__ __forceinline__ size_t lut_elems(const PmsmClArgs& args, bool sat) {
    return sat ? (size_t)N_CHANNELS_PAD * args.nx * args.ny : 0;
}
// The staged slices start after the rotations, at the next 16-byte boundary
template <typename T>
__host__ __device__ __forceinline__ size_t staged_offset(const PmsmClArgs& args, bool sat) {
    const size_t n = lut_elems(args, sat) + (size_t)args.n_pp + 16;
    return (n + Vec16<T>::N - 1) / Vec16<T>::N * Vec16<T>::N;
}
template <typename T>
__device__ __forceinline__ T* staged_slices(unsigned char* smem_raw, const PmsmClArgs& args, bool sat) {
    return reinterpret_cast<T*>(smem_raw) + staged_offset<T>(args, sat);
}

// Copy n elements of T in 16-byte pieces (n a multiple of Vec16<T>::N), the
// block's threads in turn
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const void* src, size_t n) {
    using V = typename Vec16<T>::type;
    const V* from = static_cast<const V*>(src);
    V* to = reinterpret_cast<V*>(dst);
    const int nv = (int)(n / Vec16<T>::N);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) to[i] = from[i];
}

template <typename T, int NS, bool SAT, class Policy>
__global__ void __launch_bounds__(BlockShape<T, Policy>::MAX_THREADS)
    pmsm_closed_loop_kernel(const __grid_constant__ PmsmClArgs args) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* lut = reinterpret_cast<T*>(smem_raw);
    T* pp = lut + lut_elems(args, SAT);
    T* rot = pp + args.n_pp;
    {
        // every thread of the block takes part before any returns
        const T* src = static_cast<const T*>(args.policy_params);
        for (int i = threadIdx.x; i < args.n_pp; i += blockDim.x) pp[i] = src[i];
        load_rotations(rot, args.rot_re, args.rot_im);
        if (SAT) {
            using V = typename Vec16<T>::type;
            const int n = (int)(lut_elems(args, SAT) / Vec16<T>::N);
            const V* tab = static_cast<const V*>(args.lut);
            V* dst = reinterpret_cast<V*>(lut);
            for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = tab[i];
        }
        if constexpr (sliced<Policy>()) {
            // the block's slices of the schedule, slot after slot
            T* stage = staged_slices<T>(smem_raw, args, SAT);
            const int* slots = static_cast<const int*>(args.block_slices) + (long long)blockIdx.x * args.n_staged;
            for (int j = 0; j < args.n_staged; ++j) {
                const int s = slots[j];
                if (s >= 0)
                    copy_block(stage + (size_t)j * args.slice_elems,
                               static_cast<const T*>(args.sched) + (long long)s * args.slice_elems,
                               (size_t)args.slice_elems);
            }
        }
        __syncthreads();
    }
    // the thread's drive: its position, or on the staged path perm's drive there
    long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    if constexpr (sliced<Policy>()) b = drive_of(args, b);
    const long long batch = args.batch;

    const Drive<T> k = prepare<T>(args, b);  // pmsm_drive.cuh
    const Bands<T> bd = bands<T>(args, b);
    T tau = (T)args.tau;
    keep(tau);
    const T omega = k.omega;
    const int n_obs = N_BASE_OBS + args.n_refs;
    const Tableau<T, NS> tb = tableau<T, NS>(args.a, args.b);
    const T adv_inc = omega * tau * (T)args.adv_scale;  // the hexagon's advance of the angle
    const bool deadtime = args.deadtime != 0;

    // the angle rate sum_j b_j * omega (unit weights not multiplied, zeros skipped)
    T rate = T(0);
    {
        bool any = false;
#pragma unroll
        for (int j = 0; j < MAX_STAGES; ++j) {
            if (j < args.n_rate && args.rate_b[j] != 0.0) {
                const T term = args.rate_b[j] == 1.0 ? omega : (T)args.rate_b[j] * omega;
                rate = any ? rate + term : term;
                any = true;
            }
        }
    }
    const T eps_inc = tau * rate;
    const T obs_omega = normalize(bd, 2, omega);
    T ref[MAX_REFS];
#pragma unroll
    for (int r = 0; r < MAX_REFS; ++r) ref[r] = r < args.n_refs ? static_cast<const T*>(args.refs[r])[b] : T(0);

    // the slabs, one row per step, and the saves: pointers advanced per step
    // which noise columns feed each observation column (bit j of feed[i]),
    // so that the observation stays in registers: the loop indexes neither
    const int n_obs_noise = args.n_obs_noise, n_proc_noise = args.n_proc_noise;
    unsigned feed[MAX_OBS];
#pragma unroll
    for (int i = 0; i < MAX_OBS; ++i) {
        feed[i] = 0u;
#pragma unroll
        for (int j = 0; j < MAX_OBS; ++j) feed[i] |= (unsigned)(j < n_obs_noise && args.obs_cols[j] == i) << j;
    }
    int noise_idx[2];
    noise_idx[0] = args.noise_idx[0];
    noise_idx[1] = args.noise_idx[1];
    const T* __restrict__ obs_noise = static_cast<const T*>(args.obs_noise) + b * n_obs_noise;
    const T* __restrict__ proc_noise = static_cast<const T*>(args.proc_noise) + b * n_proc_noise;
    const int traj_stride = args.traj_stride;
    const bool saves = traj_stride > 0;
    int until_save = traj_stride;
    long long save_at = b;

    T i_d = static_cast<const T*>(args.state0[0])[b];
    T i_q = static_cast<const T*>(args.state0[1])[b];
    T eps = static_cast<const T*>(args.state0[2])[b];
    T buf_d = static_cast<const T*>(args.state0[3])[b];
    T buf_q = static_cast<const T*>(args.state0[4])[b];
    T c[MAX_CARRY];
#pragma unroll
    for (int i = 0; i < MAX_CARRY; ++i) c[i] = i < args.n_carry ? static_cast<const T*>(args.carry0[i])[b] : T(0);
    T u_app_d = T(0), u_app_q = T(0);
    const auto pol = prepare_policy<Policy>(args, pp, c);
    const T* __restrict__ sched = sched_table<Policy, T>(args, pol);
    constexpr int COLS = Policy::COLUMNS;

    for (int t = 0; t < args.n_steps; ++t) {
        // 1. torque from the currents; the gather feeds the first RK stage.
        // A policy that reads no torque column gets it only for a save
        T vals[N_CHANNELS];
        if (SAT) gather<true>(lut, k, i_d, i_q, vals);
        // the pending save's torque: this state is step t - 1's post-step state
        const bool save_trq = saves && until_save == traj_stride && t > 0;
        T trq = T(0);
        if (column_read(COLS, 3) || save_trq)
            trq = SAT ? saturated_torque(vals, k, i_d, i_q) : linear_torque(k, i_d, i_q);
        if (save_trq) static_cast<T*>(args.traj[2])[save_at - batch] = trq;

        // 2. observation (+ sensor noise), the columns the policy reads
        T obs[MAX_OBS];
        obs[0] = normalize(bd, 0, i_d);
        obs[1] = normalize(bd, 1, i_q);
        obs[2] = obs_omega;
        if constexpr (COLS == COLS_ALL) {
            obs[3] = normalize(bd, 3, trq);
            sincos_pair(eps, obs[5], obs[4]);
            obs[6] = normalize(bd, 4, buf_d);
            obs[7] = normalize(bd, 5, buf_q);
        } else {
#pragma unroll
            for (int i = 3; i < N_BASE_OBS; ++i) obs[i] = T(0);  // read by no gain
        }
#pragma unroll
        for (int r = 0; r < MAX_REFS; ++r) obs[N_BASE_OBS + r] = ref[r];
        if (n_obs_noise > 0) {
            // per column, its noise columns in their order (the plain
            // version adds them column by column in that order)
#pragma unroll
            for (int i = 0; i < MAX_OBS; ++i) {
#pragma unroll
                for (int j = 0; j < MAX_OBS; ++j)
                    if (column_read(COLS, i) && ((feed[i] >> j) & 1u)) obs[i] = obs[i] + __ldg(obs_noise + j);
            }
            obs_noise += batch * n_obs_noise;
        }

        // 3. the scheduled gather at the denormalized belief currents (the
        // launcher pairs the maps with the scheduled family's functors)
        T sv[MAX_SCHED];
        if constexpr (Policy::SCHEDULED) {
            T bc0 = c[0], bc1 = c[1];
#pragma unroll
            for (int i = 1; i < MAX_CARRY; ++i) {
                bc0 = args.sched_c0 == i ? c[i] : bc0;
                bc1 = args.sched_c1 == i ? c[i] : bc1;
            }
            const T bi_d = (bc0 + T(1)) * (T)0.5 * bd.obs_dspan[0] + bd.obs_dlo[0];
            const T bi_q = (bc1 + T(1)) * (T)0.5 * bd.obs_dspan[1] + bd.obs_dlo[1];
            if constexpr (sliced<Policy>()) {
                // the drive's slice from shared memory where its block staged it
                if (pol.slot >= 0)
                    gather_il<MAX_SCHED, MAX_SCHED_PAD, false>(
                        staged_slices<T>(smem_raw, args, SAT) + (long long)pol.slot * args.slice_elems, k, bi_d, bi_q, sv);
                else
                    gather_il<MAX_SCHED, MAX_SCHED_PAD, true>(sched, k, bi_d, bi_q, sv);
            } else {
                gather_il<MAX_SCHED, MAX_SCHED_PAD, true>(sched, k, bi_d, bi_q, sv);
            }
        }

        // 4. the policy
        T a[2];
        if constexpr (Policy::PREPARES)
            Policy::template act<T>(pol, args, pp, obs, n_obs, sv, t, c, a);
        else
            Policy::template act<T>(args, pp, obs, n_obs, sv, t, c, a);

        // 5. hexagon, 6. deadtime swap
        T u_con_d, u_con_q;
        hex_constrain(bd, rot, a[0], a[1], eps, adv_inc, u_con_d, u_con_q);
        if (deadtime) {
            u_app_d = buf_d;
            u_app_q = buf_q;
            buf_d = u_con_d;
            buf_q = u_con_q;
        } else {
            u_app_d = u_con_d;
            u_app_q = u_con_q;
        }

        // 7. the RK step of the currents (+ process noise)
        const T y[2] = {i_d, i_q};
        T ks[NS][2];
        if (SAT)
            saturated_rhs(vals, k, i_d, i_q, u_app_d, u_app_q, ks[0]);
        else
            linear_rhs(k, i_d, i_q, u_app_d, u_app_q, ks[0]);
#pragma unroll
        for (int s = 1; s < NS; ++s) {
            const T yi[2] = {lincomb_masked<T, NS, 2>(y[0], ks, 0, tb.a[s], tb.a_nz[s], tb.a_one[s], s, tau),
                             lincomb_masked<T, NS, 2>(y[1], ks, 1, tb.a[s], tb.a_nz[s], tb.a_one[s], s, tau)};
            ode<T, SAT, true>(lut, k, yi, u_app_d, u_app_q, ks[s]);
        }
        i_d = lincomb_masked<T, NS, 2>(y[0], ks, 0, tb.b, tb.b_nz, tb.b_one, NS, tau);
        i_q = lincomb_masked<T, NS, 2>(y[1], ks, 1, tb.b, tb.b_nz, tb.b_one, NS, tau);
        if (n_proc_noise > 0) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (j < n_proc_noise) {
                    const T e = __ldg(proc_noise + j);
                    if (noise_idx[j] == 0) i_d = i_d + e;
                    if (noise_idx[j] == 1) i_q = i_q + e;
                }
            }
            proc_noise += batch * n_proc_noise;
        }

        // 8. the angle
        eps = wrap_angle(eps + eps_inc);

        if (saves && --until_save == 0) {
            until_save = traj_stride;
            static_cast<T*>(args.traj[0])[save_at] = i_d;
            static_cast<T*>(args.traj[1])[save_at] = i_q;
            static_cast<T*>(args.traj[3])[save_at] = u_con_d;
            static_cast<T*>(args.traj[4])[save_at] = u_con_q;
            static_cast<T*>(args.traj[5])[save_at] = a[0];
            static_cast<T*>(args.traj[6])[save_at] = a[1];
#pragma unroll
            for (int i = 0; i < MAX_CARRY; ++i)
                if (i < args.n_carry) static_cast<T*>(args.traj_carry[i])[save_at] = c[i];
            save_at += batch;
        }
    }

    const T trq = torque<T, SAT, true>(lut, k, i_d, i_q);
    if (saves && args.n_steps > 0) static_cast<T*>(args.traj[2])[save_at - batch] = trq;
    static_cast<T*>(args.out[0])[b] = i_d;
    static_cast<T*>(args.out[1])[b] = i_q;
    static_cast<T*>(args.out[2])[b] = eps;
    static_cast<T*>(args.out[3])[b] = buf_d;
    static_cast<T*>(args.out[4])[b] = buf_q;
    static_cast<T*>(args.out[5])[b] = trq;
    if (args.u_last[0] != nullptr) {
        static_cast<T*>(args.u_last[0])[b] = u_app_d;
        static_cast<T*>(args.u_last[1])[b] = u_app_q;
    }
#pragma unroll
    for (int i = 0; i < MAX_CARRY; ++i)
        if (i < args.n_carry) static_cast<T*>(args.carry_out[i])[b] = c[i];
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

template <typename T, int NS, bool SAT, class Policy>
static int launch_one(const PmsmClArgs& args, cudaStream_t stream) {
    // a SLICED functor's staged path: the host's slice tiling (perm,
    // block_slices) sizes the blocks and the slices each stages
    int threads = THREADS;
    size_t smem = (lut_elems(args, SAT) + (size_t)args.n_pp + 16) * sizeof(T);
    if constexpr (sliced<Policy>()) {
        if (args.block_threads > 0) {
            if (args.perm == nullptr || args.block_slices == nullptr || args.n_staged < 1 ||
                args.block_threads % 32 != 0 || args.block_threads > BlockShape<T, Policy>::MAX_THREADS)
                return (int)cudaErrorInvalidValue;
            threads = args.block_threads;
            smem = (staged_offset<T>(args, SAT) + (size_t)args.n_staged * (size_t)args.slice_elems) * sizeof(T);
        }
    }
    if (smem > STATIC_SMEM_LIMIT) {
        // above 48 KB a launch is refused unless the kernel opts in
        const cudaError_t err = cudaFuncSetAttribute(pmsm_closed_loop_kernel<T, NS, SAT, Policy>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that no later launch reports it
            return (int)err;
        }
    }
    const unsigned blocks = (unsigned)((args.batch + threads - 1) / threads);
    pmsm_closed_loop_kernel<T, NS, SAT, Policy><<<blocks, threads, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <typename T, bool SAT, class Policy>
static int launch_stages(const PmsmClArgs& args, cudaStream_t stream) {
    // the stage counts of the registered explicit solvers (FSAL last stage
    // skipped): Euler 1, Midpoint and Heun 2, RK4 4, Tsit5 and Dopri5 6
    switch (args.n_stages) {
        case 1: return launch_one<T, 1, SAT, Policy>(args, stream);
        case 2: return launch_one<T, 2, SAT, Policy>(args, stream);
        case 4: return launch_one<T, 4, SAT, Policy>(args, stream);
        case 6: return launch_one<T, 6, SAT, Policy>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The PPO actor's instantiations, pmsm_closed_loop/actor.cu: ActorReg<16, 16>
// where the widths are (n_obs, 16, 16, 2), ActorLaw otherwise; dtype 0
// float32, 1 float64
int pmsm_closed_loop_actor(const PmsmClArgs& args, int dtype, cudaStream_t stream);

// AffinePolicy's instantiations, pmsm_closed_loop/affine.cu, by
// args.affine_columns: AffineAdapter over every column, AffineCurrentsReg
// over the currents' columns; dtype 0 float32, 1 float64
int pmsm_closed_loop_affine(const PmsmClArgs& args, int dtype, cudaStream_t stream);
