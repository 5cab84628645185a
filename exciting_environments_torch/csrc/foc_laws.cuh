// Drive-control tiles of the closed-loop kernel (closed_loop.cuh) for the
// induction machine and the EESM: the functors of utils/foc.py's FocPolicy
// (id 4), SensorlessFocPolicy (id 5) and EesmCurrentPolicy (id 6), and the
// two FOC tiles of a fleet whose drives each hold their own operating point
// (FocDriveTile, SensorlessFocDriveTile).  They run
// inside the closed loop of exciting_environments_tpu/ops/pallas/stepper.py::
// _make_closed_loop_kernel, which traces the JAX package's Python tiles
// (utils/foc.py::make_foc_tile, make_sensorless_foc_tile,
// make_eesm_current_tile) into its body.
//
// A functor has the closed-loop kernel's policy interface: N_CARRY, the
// carry planes it threads; prepare<T, A>(args, pp, carry) once per thread;
// act<T, A, NO>(p, args, pp, obs, n_obs, t, carry, a) per step.  VARIANT is
// its ClosedLoopArgs.variant (ops/kernels/closed_loop.py::VARIANTS); the
// unit of its machine, closed_loop/<environment>.cu, compiles it in.  pp is the
// flat vector of the policy's kernel_spec in shared memory, SLOTS in the
// order of the enums below (tests/test_torch_machine_foc.py checks them
// against the Python classes' SLOTS); every value is a Python number there,
// folded in double as the plain tile folds it and rounded once to the
// working type, so each step reads broadcasts from shared memory and no
// division by a constant.
//
// What bounds them on an H100: operations.  A tile reads nothing from device
// memory per step; the FOC law is about 90 operations per step (three square
// roots and three divisions among them), the sensorless observer about 45
// more, the EESM's PIs about 45.  As with the other families, one dependent
// chain per instance sets the time.
//
// Exactness: each operation mirrors the tile's forward on CUDA tensors, in
// order and working precision, under PyTorch's CUDA eager rules
// (eager_rules.cuh): a division by a Python number is a multiply by its
// reciprocal taken in double (the flat vector holds 1 / x); a Python number
// over a tensor is reciprocal(y) * x; a clamp by Python numbers is
// fmax/fmin with a NaN kept, a clamp by tensors keeps the first NaN of
// (v, lo, hi).  Below the flux floor the law orients on cos/sin of the step
// angle (double) frame_step * k rounded to the working type, as
// torch.full_like(x, omega * tau * k) is; the cosine and sine are computed
// only there (cosf/sinf in float32, which chip_smoke.py's trig phase holds
// against torch.cos/torch.sin).  The observer skips every term whose gain,
// A or B coefficient is exactly 0.0 (the bit masks of the flat vector,
// from the Python doubles) and sums from 0.0 in index order: a NaN in a column
// the tile does not measure never reaches the action.
//
// Per drive.  A fleet spread over the torque-speed plane gives each drive its
// own speed omega and torque setpoint, and the sensorless tile one Kalman
// filter per drive at that drive's speed.  Those constants arrive as (B,)
// planes (ClosedLoopArgs.policy_planes, in the order of the Python classes'
// PLANES); prepare loads the drive's values into registers once, and act
// reads them there: FocDriveTile and SensorlessFocDriveTile run the folded
// tiles' bodies (FocTile::run, SensorlessFocTile::observe) on a DrivePoint
// and, for the observer, on gains read from registers.  The plain tile computes them on tensors, so the rules
// change with them: the torque current is a true division, T* / (TQ_GAIN
// denom), and the fallback frame's angle is the plane omega * tau (rounded
// to the working type, as the tensor product is) times k.  Every other
// constant stays folded in the flat vector, read as the folded tiles read
// it.  The observer's masks hold a term that is non-zero for some drive.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"

// torch.clamp(v, lo, hi) with tensor bounds as PyTorch's CUDA kernel computes
// it: the first NaN of (v, lo, hi), else fmin(fmax(v, lo), hi)
template <typename T>
__device__ __forceinline__ T clamp_tensors(T v, T lo, T hi) {
    if (isnan(v)) return v;
    if (isnan(lo)) return lo;
    if (isnan(hi)) return hi;
    return clamp_max(clamp_min(v, lo), hi);
}

// torch.clamp(v, lo, hi) with Python-number bounds
template <typename T>
__device__ __forceinline__ T clamp_scalars(T v, T lo, T hi) {
    return clamp_max(clamp_min(v, lo), hi);
}

// The voltage-vector limit's scale torch.clamp(u_lim / torch.clamp(|u|,
// min=1e-9), max=1.0), the division as reciprocal(m) * u_lim; |u| returned
// in mag
template <typename T>
__device__ __forceinline__ T limit_scale(T u_d, T u_q, T u_lim, T& mag) {
    mag = dsqrt(u_d * u_d + u_q * u_q);
    return clamp_max((T(1) / clamp_min(mag, (T)1e-9)) * u_lim, T(1));
}

// utils/foc.py::FocLaw on the physical (i_sd, i_sq, psi_rd, psi_rq) at step
// k; c = (int_d, int_q, int_psi, free) updated in place.  Slots: FocLaw.SLOTS.
struct FocLaw {
    enum { PSI_FLOOR, PSI_STAR, KP_PSI, PSI_FF, I_LO, I_HI, KIPSI_TAU, AW_PSI, I_MAX_SQ, TORQUE_REF, TQ_GAIN,
           HALF_PSI, INV_QUARTER_PSI, L_M, TAU_R, OMEGA, KP, SIGMA_LS, K_R, U_LIM, KI_TAU, AW, INV_UMAX_D,
           INV_UMAX_Q, N_SLOTS };

    // pt: the operating point (FoldedPoint, DrivePoint below): the fallback
    // frame's angle, the torque current before its clamp and the speed
    template <typename T, class Point>
    __device__ __forceinline__ static void act(const T* pp, const Point& pt, T i_sd, T i_sq, T psi_rd, T psi_rq,
                                               T* c, int k, T& a_sd, T& a_sq) {
        // 1. orientation on the flux; below the floor a frame rotating at the
        // rotor speed
        const T psi_mag = dsqrt(psi_rd * psi_rd + psi_rq * psi_rq);
        const T psi_floor = pp[PSI_FLOOR];
        const T denom = clamp_min(psi_mag, psi_floor);
        T cos_rho, sin_rho;
        if (psi_mag > psi_floor) {
            cos_rho = psi_rd / denom;
            sin_rho = psi_rq / denom;
        } else {
            const T theta = pt.theta(k);
            cos_rho = dcos(theta);
            sin_rho = dsin(theta);
        }
        // 2. the currents in the flux frame
        const T i_d = cos_rho * i_sd + sin_rho * i_sq;
        const T i_q = cos_rho * i_sq - sin_rho * i_sd;
        // 3. the flux PI and its anti-windup, the torque current in the
        // remaining circle
        const T int_d = c[0], int_q = c[1], int_psi = c[2];
        const bool unrailed = c[3] > T(0);  // last step's voltage vector inside the limit
        const T e_psi = pp[PSI_STAR] - psi_mag;
        const T i_d_raw = (pp[KP_PSI] * e_psi + pp[PSI_FF]) + int_psi;
        const T i_d_ref = clamp_scalars(i_d_raw, pp[I_LO], pp[I_HI]);
        const bool unwind = e_psi * i_d_raw < T(0);
        const T int_psi1 =
            (int_psi + ((unrailed || unwind) ? pp[KIPSI_TAU] * e_psi : T(0))) + pp[AW_PSI] * (i_d - i_d_raw);
        const T i_q_cap = dsqrt(clamp_min(pp[I_MAX_SQ] - i_d_ref * i_d_ref, T(0)));
        const T i_q_raw = pt.torque_current(pp, denom);
        // 4. magnetize first
        const T gate = clamp_scalars((psi_mag - pp[HALF_PSI]) * pp[INV_QUARTER_PSI], T(0), T(1));
        const T i_q_ref = gate * clamp_tensors(i_q_raw, -i_q_cap, i_q_cap);
        // 5. the current PIs with the decoupling feedforward
        const T e_d = i_d_ref - i_d;
        const T e_q = i_q_ref - i_q;
        const T omega_s = (pp[L_M] * i_q) / (pp[TAU_R] * denom) + pt.omega(pp);
        const T u_d_unsat = (pp[KP] * e_d + int_d) - (omega_s * pp[SIGMA_LS]) * i_q;
        const T u_q_unsat = (pp[KP] * e_q + int_q) + omega_s * (pp[SIGMA_LS] * i_d + pp[K_R] * psi_mag);
        // 6. the voltage-vector limit, back-calculation, back to the
        // stationary frame
        T u_mag;
        const T scale = limit_scale(u_d_unsat, u_q_unsat, pp[U_LIM], u_mag);
        const T u_d = u_d_unsat * scale;
        const T u_q = u_q_unsat * scale;
        c[0] = (int_d + pp[KI_TAU] * e_d) + pp[AW] * (u_d - u_d_unsat);
        c[1] = (int_q + pp[KI_TAU] * e_q) + pp[AW] * (u_q - u_q_unsat);
        c[2] = int_psi1;
        c[3] = u_mag <= pp[U_LIM] ? T(1) : T(0);
        a_sd = (cos_rho * u_d - sin_rho * u_q) * pp[INV_UMAX_D];
        a_sq = (sin_rho * u_d + cos_rho * u_q) * pp[INV_UMAX_Q];
    }
};

// The folded operating point: the speed and torque setpoint from the flat
// vector, the fallback frame's angle per step (double) from the launch
template <typename T>
struct FoldedPoint {
    double frame_step;
    __device__ __forceinline__ T theta(int k) const { return (T)(frame_step * (double)k); }
    // a Python number over a tensor: reciprocal(y) * x
    __device__ __forceinline__ T torque_current(const T* pp, T denom) const {
        return (T(1) / (pp[FocLaw::TQ_GAIN] * denom)) * pp[FocLaw::TORQUE_REF];
    }
    __device__ __forceinline__ T omega(const T* pp) const { return pp[FocLaw::OMEGA]; }
};

// One drive's operating point, from its planes: speed, torque setpoint and
// omega * tau in the working type
template <typename T>
struct DrivePoint {
    T w, torque, frame;
    __device__ __forceinline__ T theta(int k) const { return frame * (T)k; }
    // a tensor over a tensor: a true division
    __device__ __forceinline__ T torque_current(const T* pp, T denom) const {
        return torque / (pp[FocLaw::TQ_GAIN] * denom);
    }
    __device__ __forceinline__ T omega(const T*) const { return w; }
};

// The thread's instance, as closed_loop_kernel computes it
__device__ __forceinline__ long long foc_instance() { return (long long)blockIdx.x * blockDim.x + threadIdx.x; }

// Element b of per-drive plane i
template <typename T, class Args>
__device__ __forceinline__ T drive_plane(const Args& args, int i, long long b) {
    return static_cast<const T*>(args.policy_planes[i])[b];
}

// The drive's operating point from the planes OMEGA, TORQUE_REF, FRAME_STEP
// (0-2), pinned in registers
template <typename T, class Args>
__device__ __forceinline__ DrivePoint<T> drive_point(const Args& args, long long b) {
    DrivePoint<T> pt{drive_plane<T>(args, 0, b), drive_plane<T>(args, 1, b), drive_plane<T>(args, 2, b)};
    keep(pt.w);
    keep(pt.torque);
    keep(pt.frame);
    return pt;
}

// (o + 1) / 2 * (mx - mn) + mn with the span and min at pp[at], pp[at + 1]
template <typename T>
__device__ __forceinline__ T denormalized(T o, const T* pp, int at) {
    return (o + T(1)) * T(0.5) * pp[at] + pp[at + 1];
}

// utils/foc.py::FocPolicy: the law on the denormalized state columns.
// Slots: FocPolicy.SLOTS.
struct FocTile {
    static constexpr int VARIANT = 4, N_CARRY = 4;
    enum { SPAN0 = FocLaw::N_SLOTS, MN0, SPAN1, MN1, SPAN2, MN2, SPAN3, MN3, N_SLOTS };
    template <typename T, int A>
    struct Prepared {
        FoldedPoint<T> pt;
    };
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args& args, const T*, const T*) {
        return {{args.frame_step}};
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const Args&, const T* pp, const T (&obs)[NO],
                                               int, int t, T* c, T (&a)[A]) {
        run(p.pt, pp, obs, t, c, a);
    }
    // the law at the operating point pt (FoldedPoint, DrivePoint)
    template <typename T, int A, int NO, class Point>
    __device__ __forceinline__ static void run(const Point& pt, const T* pp, const T (&obs)[NO], int t, T* c,
                                               T (&a)[A]) {
        static_assert(A == 2 && NO >= 4, "the induction machine's tile");
        FocLaw::act(pp, pt, denormalized(obs[0], pp, SPAN0), denormalized(obs[1], pp, SPAN1),
                    denormalized(obs[2], pp, SPAN2), denormalized(obs[3], pp, SPAN3), c, t, a[0], a[1]);
    }
};

// utils/foc.py::FocPolicy on a per-drive law: FocTile's flat vector (its
// OMEGA and TORQUE_REF slots unread), the drive's point from its planes.
// Planes: FocLaw.PLANES.
struct FocDriveTile {
    static constexpr int VARIANT = 7, N_CARRY = 4;
    enum { OMEGA, TORQUE_REF, FRAME_STEP, N_PLANES };
    template <typename T, int A>
    struct Prepared {
        DrivePoint<T> pt;
    };
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args& args, const T*, const T*) {
        return {drive_point<T>(args, foc_instance())};
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const Args&, const T* pp, const T (&obs)[NO],
                                               int, int t, T* c, T (&a)[A]) {
        FocTile::run(p.pt, pp, obs, t, c, a);
    }
};

// The observer's measured columns (at most M) and the bit masks of its
// non-zero K, A and B terms, pinned in registers
template <int M>
struct ObserverIndex {
    unsigned n_meas, midx[M], zcol[M];
    unsigned k_nz, a_nz, b_nz;  // bit 4 i + k, 4 i + j, 2 i + k
};

// utils/foc.py::SensorlessFocPolicy: the stationary Kalman observer on the
// measured columns (carry 0-3, the normalized predicted belief), the law on
// its corrected belief (carry 4-7).  Slots: SensorlessFocPolicy.SLOTS; the
// gains K[i][k], A[i][j] and B[i][k] row-major, then the non-zero masks of
// the three as integers (bit 4 i + k, 4 i + j, 2 i + k).
struct SensorlessFocTile {
    static constexpr int VARIANT = 5, N_CARRY = 8;
    enum { SPAN0 = FocLaw::N_SLOTS, MN0, SPAN1, MN1, SPAN2, MN2, SPAN3, MN3, N_MEAS, MIDX0, ZCOL0 = MIDX0 + 4,
           K0 = ZCOL0 + 4, A0 = K0 + 16, B0 = A0 + 16, C0 = B0 + 8, K_MASK = C0 + 4, A_MASK, B_MASK, N_SLOTS };
    // the observer's K and A, from the flat vector
    template <typename T>
    struct Gains {
        __device__ __forceinline__ T k(const T* pp, int i, int m) const { return pp[K0 + 4 * i + m]; }
        __device__ __forceinline__ T a(const T* pp, int i, int j) const { return pp[A0 + 4 * i + j]; }
    };
    template <typename T, int A>
    struct Prepared {
        FoldedPoint<T> pt;
        Gains<T> g;
        ObserverIndex<4> ix;
    };
    template <int M, typename T>
    __device__ __forceinline__ static ObserverIndex<M> index(const T* pp) {
        ObserverIndex<M> ix;
        ix.n_meas = (unsigned)pp[N_MEAS];
        keep(ix.n_meas);
#pragma unroll
        for (int k = 0; k < M; ++k) {
            ix.midx[k] = (unsigned)pp[MIDX0 + k];
            ix.zcol[k] = (unsigned)pp[ZCOL0 + k];
            keep(ix.midx[k]);
            keep(ix.zcol[k]);
        }
        ix.k_nz = (unsigned)pp[K_MASK];
        ix.a_nz = (unsigned)pp[A_MASK];
        ix.b_nz = (unsigned)pp[B_MASK];
        keep(ix.k_nz);
        keep(ix.a_nz);
        keep(ix.b_nz);
        return ix;
    }
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args& args, const T* pp, const T*) {
        Prepared<T, A> p;
        p.pt.frame_step = args.frame_step;
        p.ix = index<4>(pp);
        return p;
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const Args&, const T* pp, const T (&obs)[NO],
                                               int, int t, T* c, T (&a)[A]) {
        observe(p.pt, p.g, p.ix, pp, obs, t, c, a);
    }
    // the observer with the gains g (Gains, SensorlessFocDriveTile::Gains)
    // and the law at the operating point pt
    template <typename T, int A, int NO, int M, class Point, class G>
    __device__ __forceinline__ static void observe(const Point& pt, const G& g, const ObserverIndex<M>& ix,
                                                   const T* pp, const T (&obs)[NO], int t, T* c, T (&a)[A]) {
        static_assert(A == 2 && NO >= 4, "the induction machine's tile");
        // innovations of the measured columns against the predicted belief
        // (indices picked by value: no register array is indexed at run time)
        T innov[M];
#pragma unroll
        for (int k = 0; k < M; ++k) {
            T z = obs[0], xm = c[0];
            if ((unsigned)k < ix.n_meas) {
#pragma unroll
                for (int j = 1; j < 4; ++j) {
                    if (ix.zcol[k] == (unsigned)j) z = obs[j];
                    if (ix.midx[k] == (unsigned)j) xm = c[j];
                }
            }
            innov[k] = z - xm;
        }
        // correct: xh + the non-zero gain terms, summed from 0.0
        T xc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < M; ++k)
                if ((ix.k_nz >> (4 * i + k)) & 1u) acc = acc + g.k(pp, i, k) * innov[k];
            xc[i] = c[i] + acc;
        }
        FocLaw::act(pp, pt, denormalized(xc[0], pp, SPAN0), denormalized(xc[1], pp, SPAN1),
                    denormalized(xc[2], pp, SPAN2), denormalized(xc[3], pp, SPAN3), c + 4, t, a[0], a[1]);
        // predict with the emitted actions: (sum_A + c) + sum_B
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            T sa = T(0), sb = T(0);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if ((ix.a_nz >> (4 * i + j)) & 1u) sa = sa + g.a(pp, i, j) * xc[j];
#pragma unroll
            for (int k = 0; k < 2; ++k)
                if ((ix.b_nz >> (2 * i + k)) & 1u) sb = sb + pp[B0 + 2 * i + k] * a[k];
            c[i] = (sa + pp[C0 + i]) + sb;
        }
    }
};

// utils/foc.py::SensorlessFocPolicy with one filter per drive:
// SensorlessFocTile's observer on at most two measured columns with the
// drive's gain K (planes K00-K31) and the A entries that its speed moves
// (planes A03, A12, A23, A32; every other A entry, B and c from
// SensorlessFocTile's flat vector), then the law at the drive's point.
// Planes: SensorlessFocPolicy.PLANES.
struct SensorlessFocDriveTile {
    static constexpr int VARIANT = 8, N_CARRY = 8;
    enum { OMEGA, TORQUE_REF, FRAME_STEP, K00, K01, K10, K11, K20, K21, K30, K31, A03, A12, A23, A32, N_PLANES };
    // the plane of A entry (i, j) among A03-A32, or -1: the flat vector's
    __device__ __forceinline__ static int drive_a(int i, int j) {
        return i == 0 && j == 3 ? 0 : i == 1 && j == 2 ? 1 : i == 2 && j == 3 ? 2 : i == 3 && j == 2 ? 3 : -1;
    }
    // the drive's K and speed-dependent A entries, in registers
    template <typename T>
    struct Gains {
        T kk[4][2], aa[4];
        __device__ __forceinline__ T k(const T*, int i, int m) const { return kk[i][m]; }
        __device__ __forceinline__ T a(const T* pp, int i, int j) const {
            const int d = drive_a(i, j);
            return d >= 0 ? aa[d < 0 ? 0 : d] : pp[SensorlessFocTile::A0 + 4 * i + j];
        }
    };
    template <typename T, int A>
    struct Prepared {
        DrivePoint<T> pt;
        Gains<T> g;
        ObserverIndex<2> ix;
    };
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args& args, const T* pp, const T*) {
        Prepared<T, A> p;
        const long long b = foc_instance();
        p.pt = drive_point<T>(args, b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                p.g.kk[i][k] = drive_plane<T>(args, K00 + 2 * i + k, b);
                keep(p.g.kk[i][k]);
            }
            p.g.aa[i] = drive_plane<T>(args, A03 + i, b);
            keep(p.g.aa[i]);
        }
        p.ix = SensorlessFocTile::index<2>(pp);
        return p;
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const Args&, const T* pp, const T (&obs)[NO],
                                               int, int t, T* c, T (&a)[A]) {
        SensorlessFocTile::observe(p.pt, p.g, p.ix, pp, obs, t, c, a);
    }
};

// utils/foc.py::EesmCurrentPolicy: dq and field current PIs.  Slots:
// EesmCurrentPolicy.SLOTS; carry (int_d, int_q, int_f).
struct EesmCurrentTile {
    static constexpr int VARIANT = 6, N_CARRY = 3;
    enum { SPAN0, MN0, SPAN1, MN1, SPAN2, MN2, REF_D, REF_Q, REF_F, KP, KP_F, FF_D, FF_Q, FF_F, W_LQ, OMEGA, L_D,
           L_M, U_LIM, UF_LO, UF_HI, KI_TAU, KIF_TAU, AW, AW_F, INV_UMAX_D, INV_UMAX_Q, INV_UMAX_F, N_SLOTS };
    template <typename T, int A>
    struct Prepared {};
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args&, const T*, const T*) {
        return {};
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>&, const Args&, const T* pp, const T (&obs)[NO],
                                               int, int, T* c, T (&a)[A]) {
        static_assert(A == 3 && NO >= 3, "the EESM's tile");
        const T i_d = denormalized(obs[0], pp, SPAN0);
        const T i_q = denormalized(obs[1], pp, SPAN1);
        const T i_f = denormalized(obs[2], pp, SPAN2);
        const T int_d = c[0], int_q = c[1], int_f = c[2];
        const T e_d = pp[REF_D] - i_d;
        const T e_q = pp[REF_Q] - i_q;
        const T e_f = pp[REF_F] - i_f;
        const T u_d_unsat = ((pp[KP] * e_d + int_d) + pp[FF_D]) - pp[W_LQ] * i_q;
        const T u_q_unsat = ((pp[KP] * e_q + int_q) + pp[FF_Q]) + pp[OMEGA] * (pp[L_D] * i_d + pp[L_M] * i_f);
        const T u_f_unsat = (pp[KP_F] * e_f + int_f) + pp[FF_F];
        T u_mag;
        const T scale = limit_scale(u_d_unsat, u_q_unsat, pp[U_LIM], u_mag);
        const T u_d = u_d_unsat * scale;
        const T u_q = u_q_unsat * scale;
        const T u_f = clamp_scalars(u_f_unsat, pp[UF_LO], pp[UF_HI]);
        c[0] = (int_d + pp[KI_TAU] * e_d) + pp[AW] * (u_d - u_d_unsat);
        c[1] = (int_q + pp[KI_TAU] * e_q) + pp[AW] * (u_q - u_q_unsat);
        c[2] = (int_f + pp[KIF_TAU] * e_f) + pp[AW_F] * (u_f - u_f_unsat);
        a[0] = u_d * pp[INV_UMAX_D];
        a[1] = u_q * pp[INV_UMAX_Q];
        a[2] = u_f * pp[INV_UMAX_F];
    }
};
