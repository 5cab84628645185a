// PMSM drive rollout: the whole horizon of T explicit Runge-Kutta steps of
// the electrical dynamics (i_d, i_q) of every drive instance in one launch,
// from the normalized actions: the electrical angle, the inverter constraint
// and the deadtime buffer are taken in the loop.
//
// Replaces the TPU kernel exciting_environments_tpu/ops/pallas/pmsm_stepper.py::
// _make_kernel (with _gather_corners and _blend_channels, and its process-
// noise slab noise_ref / add_noise; launcher
// _pmsm_fused_core), in both of its modes, together with the angle and
// constraint pre-pass that the JAX package runs before it (_eps_trajectory,
// _constraint_denorm_batched):
//   * step mode (pmsm_fused_rollout): identical to T repeated vmap_step
//     calls: per step the pre-step angle eps_t, the environment's constraint
//     PMSM._constrain of the action at eps_t, the deadtime swap, the RK step
//     of the currents, then eps = ((eps + tau * rate + pi) % 2 pi) - pi;
//     With a process-noise slab (a stochastic drive; step mode only) the
//     pre-scaled increment of step t, noise[(t B + b) n + j], is added to
//     i_d or i_q after the RK step and before the angle and the save:
//     saves, the final state and every later step see the post-noise
//     currents, and so does the torque (pmsm_env.py::_apply_process_noise_eps
//     recomputes it from them; here the next gather, which serves the save's
//     torque, and the final torque run on them);
//   * sim-ahead mode (pmsm_fused_sim_ahead): the constraint at the angle
//     extrapolated with the environment's tau, eps0 + offset[t] * omega (the
//     offsets come from the host, pmsm_env.py::extrapolated_angles), stages
//     at c == 1 read the next applied voltage, and the angle accumulates
//     unwrapped (saved wrapped).
// The environment's constraint, per step (pmsm_env.py::_constrain):
// denormalize_action; * (1 / (u_dc / 2)); step_eps at deadtime + 0.5;
// dq2albet at -adv; transforms.py::apply_hex_constraint (atan2, the signs
// of sin(angle - 2/3 pi k) for k = 0, 1, 2, the float32 sector rotation,
// the clamps, the rotation back); albet2dq at adv; * (u_dc / 2).  It is not
// the closed loop's hex_constrain, whose sector test is linear: this kernel
// keeps atan2f and the three sinf, so that it stays bit for bit with
// vmap_rollout.
//
// Per stage: a bilinear gather of the six magnetics channels (L_dd, L_dq,
// L_qd, L_qq, Psi_d, Psi_q) at (i_d, i_q) with the closed-form 2x2 inverse of
// the differential inductance matrix (saturated), or the linear ODE; torque
// at every trajectory save and at the end.
//
// What bounds it on an H100: the action stream and the constraint.  Each
// instance reads its 2 T normalized actions once; the state is a handful of
// registers.  At the main size (BRUSA, B = 65,536, T = 256, float32) that
// is 134 MB, or 0.040 ms at 3.35 TB/s, against some 180 float32 operations
// per Euler step and instance (3.0e9 in all, 0.045 ms at 67 TFLOP/s).  In
// fact one dependent chain per drive (the gather's shared-memory loads, the
// constraint's atan2f, three sinf and one sincosf, the RK step) sets the
// time, at 15.5 warps per SM.
//
// What the design does about it: one thread per drive keeps (i_d, i_q), the
// angle, the deadtime buffer and omega_el in registers for all T steps; the
// pre-pass that an eager PyTorch version spends T launches of a few (B,)
// operations on, and some forty operations over the (T, B) slab, costs a
// few hundred instructions per step here and no device memory.  The action
// row of step t + 1 is loaded while step t runs (it does not depend on the
// state), from either layout in place: (T, B, 2) rows are B * 2 apart,
// (B, T, 2) rows 2.  The magnetics table sits in dynamic shared memory
// channel-interleaved, (nx, ny, 8) (ops/lut.py::interleave_channels; 47,488
// B for BRUSA in float32, 94,976 in float64, above 48 KB only after
// cudaFuncSetAttribute): each corner of a gather is two 16-byte loads from
// one address.  The first stage's gather serves the torque of the save
// before it (the same currents), so a save costs no gather of its own.
// The per-drive constants (tableau, step size, the angle's increment and
// advance, the bands and the DC link) are pinned in registers (keep()); the
// sector rotations sit in shared memory.  Saves are written time-major
// (n_saves, B); any B works (the ragged edge is masked).  The TPU's (8, 128)
// tiles, time chunks with revisited output blocks and VMEM budgets have no
// counterpart.
//
// The collection's epilogue (COLLECT, step mode: utils/collect.py::
// RolloutCollector.collect_fused through pmsm_fused_collect): in place of
// the six state planes each save writes what the eager path builds from
// them, PMSM.generate_observation's row of 10 (the normalized i_d, i_q,
// omega_el and torque, cos and sin of the angle, the normalized buffers and
// the normalized i_d and i_q references), generate_reward's current reward
// and the truncated and terminated flags, time-major (n_saves, B, 10),
// (n_saves, B) and two bool (n_saves, B) planes.  A warp's drives are
// neighbours, and so are their rows: the warp stages its 32 rows in shared
// memory (pair stores, free of bank conflicts at a row of 10) and writes
// them out as one contiguous run of pair stores (8 bytes a lane in float32),
// every store whole sectors; a row stored straight from its thread would
// touch ten 128-byte lines per store, a quarter of each sector it writes
// (on an H100 at B = 65,536, T = 512: 1.78 against 1.31-1.33 ms).  The reward
// and the flags are coalesced as they are.  The speed and the references
// are normalized once per drive; a saturated save's torque, known at the
// next gather, completes its row a step late, and the warp's rows go out
// then.  Every other instantiation is the rollout above, unchanged.
//
// The drive model (Drive, prepare, the gather, ode and torque) and the
// constraint's shared pieces (dc_link, the rotations, sincos_pair and
// hex_angles, advanced_angle) live in pmsm_drive.cuh, shared with the
// closed-loop kernel pmsm_closed_loop.cu.
//
// Exactness: every operation mirrors the plain version
// (ops/kernels/pmsm_stepper.py::plain_pmsm_rollout: the eager pre-pass,
// then a loop of plain_pmsm_step over the environment's own nonlinear_ode /
// linear_ode and torque maps) in order and working precision, built with
// --fmad=false
// (eager_rules.cuh):
//   (a) (i_d - x0) / dx and (i_q - y0) / dy divide by Python numbers, and so
//       do the linear ODE's / l_d and / l_q when they are scalars: on
//       PyTorch's CUDA eager path a multiply by the reciprocal taken in
//       double (Divisor);
//   (b) tensor-by-tensor divisions (l_qq / det, ...) are true divisions;
//   (c) scalars fold in double where Python folds them: 3 / 2 * p is 4.5
//       before it meets a tensor, and so are l_d - l_q, a scalar band's
//       max - min and 1 / (u_dc / 2) (Weak);
//   (d) floor, then the clamp to [0, n - 2], then the conversion to integer,
//       and w = f - i in the working type, as lut.py::bilinear_gather does;
//   (e) atan2f and sinf are the functions torch.atan2 and torch.sin call,
//       and the card holds them to it (chip_smoke.py's sector phase);
//       cos(-x) and sin(-x) come from one sincosf of x, as in the closed loop.

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "pmsm_drive.cuh"

#define MAX_STAGES 7
#define N_BANDS 5  // u_dc, then (min, max) of the u_d and u_q action bands
#define N_OBS 10   // the observation's columns with the two tracked references
// (min, max) of the six normalized fields, in the order of OBS_FIELDS in
// ops/kernels/pmsm_stepper.py: i_d, i_q, omega_el, torque, u_d_buffer, u_q_buffer
#define N_OBS_BANDS 12

enum { B_UDC = 0, B_AD_MN = 1, B_AD_MX = 2, B_AQ_MN = 3, B_AQ_MX = 4 };
enum { O_ID = 0, O_IQ = 1, O_OMEGA = 2, O_TORQUE = 3, O_BUF_D = 4, O_BUF_Q = 5 };

// Mirrored field for field by PmsmArgs in ops/kernels/pmsm_stepper.py.
struct PmsmArgs {
    double tau;                        // the solver step
    double a[MAX_STAGES][MAX_STAGES];  // a[s][j]: weight of stage j in stage s's input
    double b[MAX_STAGES];
    double rate_b[MAX_STAGES];         // the full tableau's b, for the angle rate
    double param_value[N_PARAMS];      // scalar parameter (param_ptr null)
    double x0, dx, y0, dy;             // LUT grid (Python numbers)
    double band_value[N_BANDS];        // scalar band (band_ptr null)
    double con_tau;                    // the environment's tau, the constraint's angle advance
    double adv_scale;                  // deadtime + 0.5
    double rot_re[8], rot_im[8];       // ops/transforms.py ROTATION_RE/IM at [b0][b1][b2]
    const void* param_ptr[N_PARAMS];   // per-batch parameter (B,), or null
    const void* band_ptr[N_BANDS];     // per-batch band (B,), or null
    const void* lut;                   // (nx, ny, 8) interleaved, saturated only
    const void* actions;               // normalized, (T, B, 2), or (B, T, 2) with batch_major
    const void* offsets;               // sim-ahead: (T,) constraint-angle offsets
    const void* state0[5];             // (B,) i_d, i_q, epsilon, u_d_buffer, u_q_buffer
    const void* omega;                 // (B,)
    const void* noise;                 // step mode: pre-scaled process increments (T, B, n_noise), or null
    void* out[6];                      // (B,) final i_d, i_q, torque, epsilon, u_d_buffer, u_q_buffer
    void* u_last[2];                   // (B,) the voltage applied in the last step
    void* traj[6];                     // (n_saves, B) the same six after every traj_stride-th step
                                       // (the buffers with deadtime 1 only), or null
    long long batch;
    int nx, ny;
    int n_steps;
    int n_stages;                      // stages evaluated (the FSAL last one is skipped)
    int n_rate;                        // entries of rate_b
    int saturated;
    int deadtime;                      // 0 or 1
    int traj_stride;                   // 0: no trajectory saves
    int use_next[MAX_STAGES];          // stage reads the next voltage (sim-ahead, c == 1)
    int sim_ahead;
    int batch_major;                   // layout of the action slab
    int noise_idx[2];                  // the current (0 = i_d, 1 = i_q) each noise column perturbs
    int n_noise;                       // columns of the noise slab (0: none)
    // the collection's epilogue (collect set; step mode): each save writes
    // its observation row, reward and flags in place of the traj planes
    double obs_band_value[N_OBS_BANDS];    // scalar (min, max) of OBS_FIELDS
    const void* obs_band_ptr[N_OBS_BANDS]; // per-batch band (B,), or null
    const void* refs[2];                   // (B,) i_d and i_q references
    void* obs;                             // (n_saves, B, N_OBS)
    void* reward;                          // (n_saves, B)
    void* terminated;                      // (n_saves, B) bool
    void* truncated;                       // (n_saves, B) bool
    int collect;
};

// ---------------------------------------------------------------------------
// The environment's constraint
// ---------------------------------------------------------------------------

__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }

// transforms.py::apply_hex_constraint's sector index: bit k of (b0, b1, b2)
// is sin(angle - 2/3 pi k) >= 0 with angle = atan2(beta, alpha), the
// multiples of 2/3 pi Python numbers rounded to T
template <typename T>
__device__ __forceinline__ int hex_sector(T alpha, T beta) {
    const T angle = datan2(beta, alpha);
    const int b0 = dsin(angle) >= T(0);  // angle - 0.0 is angle
    const int b1 = dsin(angle - (T)2.0943951023931953) >= T(0);
    const int b2 = dsin(angle - (T)4.1887902047863905) >= T(0);
    return b0 * 4 + b1 * 2 + b2;
}

// The action bands and the DC link of one drive
template <typename T>
struct ActionBands {
    T lo[2], span[2];  // (x + 1) / 2 * (max - min) + min
    T inv_half_dc;     // 1 / (u_dc / 2)
    T half_dc;         // u_dc / 2
};

template <typename T>
__device__ __forceinline__ ActionBands<T> action_bands(const PmsmArgs& args, long long b) {
    Weak<T> w[N_BANDS];
#pragma unroll
    for (int i = 0; i < N_BANDS; ++i) w[i] = weak_load<T>(args.band_ptr[i], args.band_value[i], b);
    ActionBands<T> k;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const Weak<T> mn = w[B_AD_MN + 2 * j], mx = w[B_AD_MX + 2 * j];
        k.lo[j] = value(mn);
        k.span[j] = value(wsub(mx, mn));
        keep(k.lo[j]);
        keep(k.span[j]);
    }
    dc_link(w[B_UDC], k.inv_half_dc, k.half_dc);
    keep(k.inv_half_dc);
    keep(k.half_dc);
    return k;
}

// PMSM._constrain of one normalized action (a_d, a_q) at the angle eps;
// adv_inc = omega * tau * (deadtime + 0.5), rot the sector rotations (8 real
// parts, then 8 imaginary ones) in the working type
template <typename T>
__device__ __forceinline__ void env_constrain(const ActionBands<T>& k, const T* rot, T a_d, T a_q, T eps,
                                              T adv_inc, T& u_con_d, T& u_con_q) {
    // denormalize_action, then the normalization by the DC link
    const T u_d = (a_d + T(1)) * (T)0.5 * k.span[0] + k.lo[0];
    const T u_q = (a_q + T(1)) * (T)0.5 * k.span[1] + k.lo[1];
    const T nd = u_d * k.inv_half_dc;
    const T nq = u_q * k.inv_half_dc;
    // dq2albet at the deadtime-advanced angle
    const T adv = advanced_angle(eps, adv_inc);
    T ca, sa, cb, sb;
    hex_angles(adv, ca, sa, cb, sb);
    const T alpha = ca * nd + sa * nq;
    const T beta = -sa * nd + ca * nq;
    // apply_hex_constraint: rotate onto the top sector, clamp, rotate back
    const int idx = hex_sector(alpha, beta);
    const T rot_re = rot[idx], rot_im = rot[8 + idx];
    T ra = alpha * rot_re - beta * rot_im;
    T rb = alpha * rot_im + beta * rot_re;
    ra = clampv(ra, (T)(-2.0 / 3.0), (T)(2.0 / 3.0));
    rb = clampv(rb, T(0), (T)(2.0 / 3.0 * 1.7320508075688772));
    const T oa = ra * rot_re + rb * rot_im;
    const T ob = rb * rot_re - ra * rot_im;
    // albet2dq at the advanced angle, then the DC link
    u_con_d = (cb * oa + sb * ob) * k.half_dc;
    u_con_q = (-sb * oa + cb * ob) * k.half_dc;
}

// ---------------------------------------------------------------------------
// The collection's epilogue
// ---------------------------------------------------------------------------

// The observation's bands of one drive (MinMaxNormalization of OBS_FIELDS):
// a scalar band's max - min folded in double, a per-batch one in the working
// type
template <typename T>
struct ObsBands {
    T lo[6];
    Divisor<T> span[6];
};

template <typename T>
__device__ __forceinline__ ObsBands<T> obs_bands(const PmsmArgs& args, long long b) {
    ObsBands<T> k;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const Weak<T> mn = weak_load<T>(args.obs_band_ptr[2 * i], args.obs_band_value[2 * i], b);
        const Weak<T> mx = weak_load<T>(args.obs_band_ptr[2 * i + 1], args.obs_band_value[2 * i + 1], b);
        k.lo[i] = value(mn);
        k.span[i] = divisor(wsub(mx, mn));
        keep(k.lo[i]);
        keep(k.span[i].v);
    }
    return k;
}

// MinMaxNormalization.normalize: 2 * (x - min) / (max - min) - 1
template <typename T>
__device__ __forceinline__ T normalize(const ObsBands<T>& k, int i, T x) {
    return (T)2 * (x - k.lo[i]) / k.span[i] - T(1);
}

// PMSM.current_reward_func(i_d, i_q, i_d_ref, i_q_ref, 0.85) on normalized
// currents, added to generate_reward's 0: 0 + -1 * (mse * (1 - gamma)) with
// mse = 0.5 * (i_d - i_d_ref) ** 2 + 0.5 * (i_q - i_q_ref) ** 2 (a square is
// x * x on PyTorch's CUDA path; 1 - gamma folded in double)
template <typename T>
__device__ __forceinline__ T current_reward(T n_id, T n_iq, T ref_d, T ref_q) {
    const T ed = n_id - ref_d, eq = n_iq - ref_q;
    const T mse = (T)0.5 * (ed * ed) + (T)0.5 * (eq * eq);
    return (T)(-1) * (mse * (T)(1.0 - 0.85)) + T(0);
}

// PMSM.generate_truncated (and generate_terminated, the same test) on
// normalized currents: sqrt(i_d ** 2 + i_q ** 2) > 1
template <typename T>
__device__ __forceinline__ bool over_current(T n_id, T n_iq) {
    return dsqrt(n_id * n_id + n_iq * n_iq) > T(1);
}

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
    using type = float2;
};
template <>
struct Vec2<double> {
    using type = double2;
};

// Columns (c, c + 1) of an observation row in one 8-byte (float32) or
// 16-byte (float64) store: a row holds an even number of values, so an even
// column is aligned
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, T x, T y) {
    typename Vec2<T>::type v;
    v.x = x;
    v.y = y;
    *reinterpret_cast<typename Vec2<T>::type*>(row + c) = v;
}

// ---------------------------------------------------------------------------
// The rollout kernel
// ---------------------------------------------------------------------------

static constexpr int THREADS = 128;

// Dynamic shared memory of one block, in elements of T: the interleaved
// magnetics table (16-byte aligned, first), then the 16 sector rotations,
// then, with COLLECT, the staged observation rows of its threads.
__host__ __device__ __forceinline__ size_t lut_elems(const PmsmArgs& args, bool sat) {
    return sat ? (size_t)N_CHANNELS_PAD * args.nx * args.ny : 0;
}

template <typename T, int NS, bool SAT, bool COLLECT>
__global__ void __launch_bounds__(THREADS) pmsm_kernel(const __grid_constant__ PmsmArgs args) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* lut = reinterpret_cast<T*>(smem_raw);
    T* rot = lut + lut_elems(args, SAT);
    {
        // every thread of the block takes part before any returns
        load_rotations(rot, args.rot_re, args.rot_im);
        if (SAT) {
            using V = typename Vec16<T>::type;
            const int n = (int)(lut_elems(args, SAT) / Vec16<T>::N);
            const V* tab = static_cast<const V*>(args.lut);
            V* dst = reinterpret_cast<V*>(lut);
            for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = tab[i];
        }
        __syncthreads();
    }
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    const long long batch = args.batch;
    const int n_steps = args.n_steps;

    const Drive<T> k = prepare<T>(args, b);  // pmsm_drive.cuh
    const ActionBands<T> bd = action_bands<T>(args, b);
    T tau = (T)args.tau;
    keep(tau);
    const Tableau<T, NS> tb = tableau<T, NS>(args.a, args.b);
    const T omega = k.omega;
    // the angle: one step adds tau * rate, rate = sum_j b_j * omega (unit
    // weights not multiplied, zeros skipped); the constraint advances it by
    // omega * tau_env * (deadtime + 0.5)
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
    T eps_inc = tau * rate;
    T adv_inc = omega * (T)args.con_tau * (T)args.adv_scale;
    keep(eps_inc);
    keep(adv_inc);
    const bool deadtime = args.deadtime != 0;
    const bool sim = args.sim_ahead != 0;
    unsigned use_next = 0u;
#pragma unroll
    for (int s = 0; s < NS; ++s) use_next |= (unsigned)(args.use_next[s] != 0) << s;
    keep(use_next);
    const bool has_next = use_next != 0u;
    // sim-ahead without deadtime reads the next step's own constrained
    // voltage: the constraint runs one row ahead
    const int ahead = (sim && has_next && !deadtime) ? 1 : 0;

    // the action rows, read in place from either layout, one row ahead
    const long long row_stride = args.batch_major ? 2 : batch * 2;
    const T* __restrict__ next_row = static_cast<const T*>(args.actions) + (args.batch_major ? b * n_steps * 2 : b * 2);
    const T* __restrict__ next_off = static_cast<const T*>(args.offsets);
    // the noise rows (step mode, where the rows run in step with the
    // actions), time-major: row t of instance b at (t B + b) n, read with
    // the action row
    const int n_noise = args.noise ? args.n_noise : 0;
    const T* __restrict__ next_noise = static_cast<const T*>(args.noise) + b * n_noise;
    const long long noise_stride = batch * n_noise;
    int rows_left = n_steps;
    T n_d = T(0), n_q = T(0), n_o = T(0);
    T n_z[2] = {T(0), T(0)};
    auto load_row = [&]() {
        if (rows_left > 0) {
            n_d = __ldg(next_row);
            n_q = __ldg(next_row + 1);
            if (sim) n_o = __ldg(next_off++);
            if (n_noise > 0) n_z[0] = __ldg(next_noise);
            if (n_noise > 1) n_z[1] = __ldg(next_noise + 1);
            next_row += row_stride;
            next_noise += noise_stride;
            --rows_left;
        }
    };

    const int traj_stride = args.traj_stride;
    const bool saves = traj_stride > 0;
    int until_save = traj_stride;
    long long save_at = b;
    bool pending = false;  // a save waits for its torque from the next gather

    // COLLECT: the bands, the normalized speed and references, once per
    // drive; each warp stages its drives' rows in shared memory and writes
    // them out together, rows * N_OBS contiguous values (its drives are
    // neighbours, and so are their rows)
    ObsBands<T> ob{};
    T n_omega = T(0), n_ref_d = T(0), n_ref_q = T(0);
    const int lane = threadIdx.x & 31;
    const int rows = (int)(batch - (b - lane) < 32 ? batch - (b - lane) : 32);  // the warp's drives
    const unsigned rows_mask = rows == 32 ? 0xffffffffu : (1u << rows) - 1u;
    T* stage = rot + 16 + (threadIdx.x - lane) * N_OBS;  // the warp's rows
    T* my_row = stage + lane * N_OBS;
    if (COLLECT) {
        ob = obs_bands<T>(args, b);
        n_omega = normalize(ob, O_OMEGA, omega);
        n_ref_d = normalize(ob, O_ID, static_cast<const T*>(args.refs[0])[b]);
        n_ref_q = normalize(ob, O_IQ, static_cast<const T*>(args.refs[1])[b]);
    }
    // COLLECT: a save's torque completes its staged row with the (omega_el,
    // torque) pair, and the warp writes its rows out to save `at` (this
    // lane's row index)
    auto complete_row = [&](long long at, T trq) {
        store_pair(my_row, 2, n_omega, normalize(ob, O_TORQUE, trq));
        __syncwarp(rows_mask);
        using V = typename Vec2<T>::type;
        const V* src = reinterpret_cast<const V*>(stage);
        V* dst = reinterpret_cast<V*>(static_cast<T*>(args.obs) + (at - lane) * N_OBS);
        for (int p = lane; p < rows * (N_OBS / 2); p += rows) dst[p] = src[p];
        __syncwarp(rows_mask);
    };

    T i_d = static_cast<const T*>(args.state0[0])[b];
    T i_q = static_cast<const T*>(args.state0[1])[b];
    const T eps0 = static_cast<const T*>(args.state0[2])[b];
    T buf_d = static_cast<const T*>(args.state0[3])[b];
    T buf_q = static_cast<const T*>(args.state0[4])[b];
    T eps = eps0;  // step mode: the wrapped angle; sim-ahead: the unwrapped accumulation
    T u_app_d = T(0), u_app_q = T(0);

    T ahead_d = T(0), ahead_q = T(0);  // with ahead: the constrained voltage of the current step
    load_row();
    if (ahead) {
        env_constrain(bd, rot, n_d, n_q, eps0 + n_o * omega, adv_inc, ahead_d, ahead_q);
        load_row();
    }

    for (int t = 0; t < n_steps; ++t) {
        const T a_d = n_d, a_q = n_q, a_o = n_o;  // row t + ahead
        const T z0 = n_z[0], z1 = n_z[1];         // step mode: the noise of step t
        load_row();                               // row t + ahead + 1, in flight during the step

        // the first stage's gather at the currents: also the torque of the
        // save before this step
        T vals[N_CHANNELS];
        if (SAT) {
            gather<true>(lut, k, i_d, i_q, vals);
            if (pending) {
                if (COLLECT)
                    complete_row(save_at - batch, saturated_torque(vals, k, i_d, i_q));
                else
                    static_cast<T*>(args.traj[2])[save_at - batch] = saturated_torque(vals, k, i_d, i_q);
                pending = false;
            }
        }

        // the constrained voltage of this step, and of the next one for the
        // c == 1 stages; the deadtime swap
        T u_con_d, u_con_q;
        if (ahead) {
            // row t + 1's voltage; at the last step the row is t's again (no
            // row is loaded past the horizon), so it reads its own
            u_con_d = ahead_d;
            u_con_q = ahead_q;
            env_constrain(bd, rot, a_d, a_q, eps0 + a_o * omega, adv_inc, ahead_d, ahead_q);
        } else {
            env_constrain(bd, rot, a_d, a_q, sim ? eps0 + a_o * omega : eps, adv_inc, u_con_d, u_con_q);
        }
        // the voltage the c == 1 stages read: without deadtime the next
        // step's own, with it this step's, which the buffer applies next
        T un_d = ahead ? ahead_d : u_con_d, un_q = ahead ? ahead_q : u_con_q;
        if (deadtime) {
            u_app_d = buf_d;
            u_app_q = buf_q;
            buf_d = u_con_d;
            buf_q = u_con_q;
            un_d = t + 1 < n_steps ? u_con_d : u_app_d;  // applied at t + 1 (clamped to the last step)
            un_q = t + 1 < n_steps ? u_con_q : u_app_q;
        } else {
            u_app_d = u_con_d;
            u_app_q = u_con_q;
        }

        // the RK step of the currents
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
            const bool nxt = (use_next >> s) & 1u;
            ode<T, SAT, true>(lut, k, yi, nxt ? un_d : u_app_d, nxt ? un_q : u_app_q, ks[s]);
        }
        i_d = lincomb_masked<T, NS, 2>(y[0], ks, 0, tb.b, tb.b_nz, tb.b_one, NS, tau);
        i_q = lincomb_masked<T, NS, 2>(y[1], ks, 1, tb.b, tb.b_nz, tb.b_one, NS, tau);

        // the process noise of this step on the currents (plain_pmsm_step's
        // y1[idx] + noise_row[:, j])
        if (n_noise > 0) {
            if (args.noise_idx[0] == 0) i_d = i_d + z0; else i_q = i_q + z0;
        }
        if (n_noise > 1) {
            if (args.noise_idx[1] == 0) i_d = i_d + z1; else i_q = i_q + z1;
        }

        // the angle
        eps = sim ? eps + eps_inc : wrap_angle(eps + eps_inc);

        if (COLLECT) {
            if (saves && --until_save == 0) {
                // the observation row (its torque pending with SAT), the
                // reward and the two flags of this step
                until_save = traj_stride;
                const T n_id = normalize(ob, O_ID, i_d), n_iq = normalize(ob, O_IQ, i_q);
                T s_eps, c_eps;
                sincos_pair(eps, s_eps, c_eps);
                store_pair(my_row, 0, n_id, n_iq);
                store_pair(my_row, 4, c_eps, s_eps);
                store_pair(my_row, 6, normalize(ob, O_BUF_D, buf_d), normalize(ob, O_BUF_Q, buf_q));
                store_pair(my_row, 8, n_ref_d, n_ref_q);
                static_cast<T*>(args.reward)[save_at] = current_reward(n_id, n_iq, n_ref_d, n_ref_q);
                const bool over = over_current(n_id, n_iq);
                static_cast<bool*>(args.terminated)[save_at] = over;
                static_cast<bool*>(args.truncated)[save_at] = over;
                if (SAT)
                    pending = true;
                else
                    complete_row(save_at, linear_torque(k, i_d, i_q));
                save_at += batch;
            }
        } else if (saves && --until_save == 0) {
            until_save = traj_stride;
            static_cast<T*>(args.traj[0])[save_at] = i_d;
            static_cast<T*>(args.traj[1])[save_at] = i_q;
            static_cast<T*>(args.traj[3])[save_at] = sim ? wrap_angle(eps) : eps;
            if (deadtime) {  // the buffer after this step holds its constrained voltage
                static_cast<T*>(args.traj[4])[save_at] = u_con_d;
                static_cast<T*>(args.traj[5])[save_at] = u_con_q;
            }
            if (SAT)
                pending = true;
            else
                static_cast<T*>(args.traj[2])[save_at] = linear_torque(k, i_d, i_q);
            save_at += batch;
        }
    }

    const T trq = torque<T, SAT, true>(lut, k, i_d, i_q);
    if (pending) {
        if (COLLECT)
            complete_row(save_at - batch, trq);
        else
            static_cast<T*>(args.traj[2])[save_at - batch] = trq;
    }
    static_cast<T*>(args.out[0])[b] = i_d;
    static_cast<T*>(args.out[1])[b] = i_q;
    static_cast<T*>(args.out[2])[b] = trq;
    static_cast<T*>(args.out[3])[b] = sim ? wrap_angle(eps) : eps;
    static_cast<T*>(args.out[4])[b] = buf_d;
    static_cast<T*>(args.out[5])[b] = buf_q;
    static_cast<T*>(args.u_last[0])[b] = u_app_d;
    static_cast<T*>(args.u_last[1])[b] = u_app_q;
}

// ---------------------------------------------------------------------------
// Host entry point (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

static constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

template <typename T, int NS, bool SAT, bool COLLECT>
static int launch_one(const PmsmArgs& args, cudaStream_t stream) {
    const size_t smem = (lut_elems(args, SAT) + 16 + (COLLECT ? THREADS * N_OBS : 0)) * sizeof(T);
    if (smem > STATIC_SMEM_LIMIT) {
        // above 48 KB a launch is refused unless the kernel opts in
        const cudaError_t err = cudaFuncSetAttribute(pmsm_kernel<T, NS, SAT, COLLECT>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, so that no later launch reports it
            return (int)err;
        }
    }
    const unsigned blocks = (unsigned)((args.batch + THREADS - 1) / THREADS);
    pmsm_kernel<T, NS, SAT, COLLECT><<<blocks, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <typename T, bool SAT, bool COLLECT>
static int launch_stages(const PmsmArgs& args, cudaStream_t stream) {
    switch (args.n_stages) {
        case 1: return launch_one<T, 1, SAT, COLLECT>(args, stream);
        case 2: return launch_one<T, 2, SAT, COLLECT>(args, stream);
        case 3: return launch_one<T, 3, SAT, COLLECT>(args, stream);
        case 4: return launch_one<T, 4, SAT, COLLECT>(args, stream);
        case 5: return launch_one<T, 5, SAT, COLLECT>(args, stream);
        case 6: return launch_one<T, 6, SAT, COLLECT>(args, stream);
        case 7: return launch_one<T, 7, SAT, COLLECT>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T, bool SAT>
static int launch_sat(const PmsmArgs& args, cudaStream_t stream) {
    return args.collect ? launch_stages<T, SAT, true>(args, stream) : launch_stages<T, SAT, false>(args, stream);
}

template <typename T>
static int launch_dtype(const PmsmArgs& args, cudaStream_t stream) {
    return args.saturated ? launch_sat<T, true>(args, stream) : launch_sat<T, false>(args, stream);
}

extern "C" int pmsm_args_size() { return (int)sizeof(PmsmArgs); }

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success): a refused launch never runs, and only this code reports it.
extern "C" int pmsm_launch(const PmsmArgs* args, int dtype, void* stream) {
    if (args->batch <= 0 || args->n_steps <= 0) return 0;
    if (args->sim_ahead && args->offsets == nullptr) return (int)cudaErrorInvalidValue;
    if (args->noise != nullptr && (args->sim_ahead || args->n_noise < 1 || args->n_noise > 2))
        return (int)cudaErrorInvalidValue;
    if (args->collect && (args->sim_ahead || args->traj_stride < 1 || !args->obs || !args->reward ||
                          !args->terminated || !args->truncated || !args->refs[0] || !args->refs[1]))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}

// ---------------------------------------------------------------------------
// The constraint's sector function, checked on the card
// ---------------------------------------------------------------------------

// atan2f(beta, alpha) and hex_sector(alpha, beta) for n float32 pairs: the
// caller holds them against torch.atan2 and the signs of torch.sin, bit for
// bit (ops/kernels/pmsm_stepper.py::sector_mismatches)
__global__ void sector_check_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                                    float* __restrict__ angle, int* __restrict__ sector, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        angle[i] = datan2(beta[i], alpha[i]);
        sector[i] = hex_sector(alpha[i], beta[i]);
    }
}

extern "C" int pmsm_sector(const float* alpha, const float* beta, float* angle, int* sector, long long n,
                           void* stream) {
    if (n <= 0) return 0;
    sector_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(alpha, beta, angle, sector, n);
    return (int)cudaGetLastError();
}
