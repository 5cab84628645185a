// The plain C entry points of the pmsm_closed_loop library, loaded with
// ctypes, and the instantiations of the two sensorless families (the
// scheduled one scalar, ScheduledLaw, and per drive, ScheduledDriveLaw): the kernel,
// its launchers and the actor's adapter are in pmsm_closed_loop.cuh, the
// affine law's instantiations in pmsm_closed_loop/affine.cu, the actor's in
// pmsm_closed_loop/actor.cu.

#include "pmsm_closed_loop.cuh"

// The inscribed-circle vector limit of both sensorless tiles: the scale
// torch.clamp(u_lim / torch.clamp(|u|, min=1e-9), max=1.0), with the
// division as reciprocal(m) * u_lim.
template <typename T>
__device__ __forceinline__ T vector_scale(T u_d, T u_q, T u_lim) {
    const T mag = dsqrt(u_d * u_d + u_q * u_q);
    const T floor = (T)1e-9;
    const T m = mag < floor ? floor : mag;
    const T s = (T(1) / m) * u_lim;
    return s > T(1) ? T(1) : s;
}

// utils/foc.py::make_pmsm_sensorless_current_tile (SensorlessPolicy); the
// slots of pp are SENSORLESS_SLOTS there.  carry = (belief d, belief q,
// integrator d, integrator q[, delayed command d, q]).
struct SensorlessLaw {
    static constexpr bool SCHEDULED = false;
    static constexpr bool PREPARES = false;
    static constexpr int COLUMNS = COLS_ALL;
    enum { K00, K01, K10, K11, A00, A01, A10, A11, B00, B01, B10, B11, C0, C1, SPAN_D, MN_D, SPAN_Q, MN_Q,
           REF_D, REF_Q, KP_D, KP_Q, FF_D, FF_Q, W_LQ, OMEGA, L_D, PSI_P, U_LIM, KITAU_D, KITAU_Q, AW_D, AW_Q,
           AMN_D, AINV_D, AMN_Q, AINV_Q, N_SLOTS };
    template <typename T>
    __device__ __forceinline__ static void act(const PmsmClArgs& args, const T* pp, const T* obs, int,
                                               const T*, int, T* c, T* a) {
        const T xh_d = c[0], xh_q = c[1], int_d = c[2], int_q = c[3];
        const T in_d = obs[0] - xh_d;
        const T in_q = obs[1] - xh_q;
        const T xc_d = xh_d + pp[K00] * in_d + pp[K01] * in_q;
        const T xc_q = xh_q + pp[K10] * in_d + pp[K11] * in_q;
        const T i_d = (xc_d + T(1)) * (T)0.5 * pp[SPAN_D] + pp[MN_D];
        const T i_q = (xc_q + T(1)) * (T)0.5 * pp[SPAN_Q] + pp[MN_Q];
        const T e_d = pp[REF_D] - i_d;
        const T e_q = pp[REF_Q] - i_q;
        const T ud_unsat = pp[KP_D] * e_d + int_d + pp[FF_D] - pp[W_LQ] * i_q;
        const T uq_unsat = pp[KP_Q] * e_q + int_q + pp[FF_Q] + pp[OMEGA] * (pp[L_D] * i_d + pp[PSI_P]);
        const T s = vector_scale(ud_unsat, uq_unsat, pp[U_LIM]);
        const T u_d = ud_unsat * s;
        const T u_q = uq_unsat * s;
        const T int_d1 = int_d + pp[KITAU_D] * e_d + pp[AW_D] * (u_d - ud_unsat);
        const T int_q1 = int_q + pp[KITAU_Q] * e_q + pp[AW_Q] * (u_q - uq_unsat);
        const T a_d = (T)2 * (u_d - pp[AMN_D]) * pp[AINV_D] - T(1);
        const T a_q = (T)2 * (u_q - pp[AMN_Q]) * pp[AINV_Q] - T(1);
        const T ap_d = args.delayed ? c[4] : a_d;
        const T ap_q = args.delayed ? c[5] : a_q;
        c[0] = pp[C0] + pp[A00] * xc_d + pp[A01] * xc_q + pp[B00] * ap_d + pp[B01] * ap_q;
        c[1] = pp[C1] + pp[A10] * xc_d + pp[A11] * xc_q + pp[B10] * ap_d + pp[B11] * ap_q;
        c[2] = int_d1;
        c[3] = int_q1;
        if (args.delayed) {
            c[4] = a_d;
            c[5] = a_q;
        }
        a[0] = a_d;
        a[1] = a_q;
    }
};

// utils/foc.py::make_pmsm_saturated_sensorless_current_tile
// (ScheduledSensorlessPolicy); the slots of pp are SCHEDULED_SLOTS there.
// sv = L_dd, L_dq, L_qd, L_qq, Psi_d, Psi_q, K00, K01, K10, K11 gathered at
// the belief.  The law is written once, in law(), for the drive's operating
// point op: ScheduledLaw reads op from the slots (one for the fleet),
// ScheduledDriveLaw from the drive's planes.
struct ScheduledLaw {
    static constexpr bool SCHEDULED = true;
    static constexpr bool SLICED = false;  // one table for every drive
    static constexpr bool PREPARES = false;
    static constexpr int COLUMNS = COLS_ALL;
    enum { SPAN_D, MN_D, SPAN_Q, MN_Q, BANDWIDTH, INV_TI, REF_D, REF_Q, FF_D, FF_Q, OMEGA, U_LIM, TAU, TAU_TI,
           AMN_D, AINV_D, AMN_Q, AINV_Q, ASPAN_D, ASPAN_Q, R_S, INV_SPAN_D, INV_SPAN_Q, N_SLOTS };
    // the references, the feedforwards r_s * i_ref and the speed
    template <typename T>
    struct OperatingPoint {
        T ref_d, ref_q, ff_d, ff_q, omega;
    };
    template <typename T>
    __device__ __forceinline__ static void act(const PmsmClArgs& args, const T* pp, const T* obs, int,
                                               const T* sv, int, T* c, T* a) {
        law(OperatingPoint<T>{pp[REF_D], pp[REF_Q], pp[FF_D], pp[FF_Q], pp[OMEGA]}, args, pp, obs, sv, c, a);
    }
    template <typename T>
    __device__ __forceinline__ static void law(const OperatingPoint<T>& op, const PmsmClArgs& args, const T* pp,
                                               const T* obs, const T* sv, T* c, T* a) {
        const T xh_d = c[0], xh_q = c[1], int_d = c[2], int_q = c[3];
        const T l_dd = sv[0], l_dq = sv[1], l_qd = sv[2], l_qq = sv[3], psi_d = sv[4], psi_q = sv[5];
        const T k00 = sv[6], k01 = sv[7], k10 = sv[8], k11 = sv[9];
        // 1. assimilate
        const T in_d = obs[0] - xh_d;
        const T in_q = obs[1] - xh_q;
        const T xc_d = xh_d + k00 * in_d + k01 * in_q;
        const T xc_q = xh_q + k10 * in_d + k11 * in_q;
        const T i_d = (xc_d + T(1)) * (T)0.5 * pp[SPAN_D] + pp[MN_D];
        const T i_q = (xc_q + T(1)) * (T)0.5 * pp[SPAN_Q] + pp[MN_Q];
        // 2. constant-bandwidth PI with the saturated back-EMF feedforward
        const T kp_d = pp[BANDWIDTH] * l_dd;
        const T kp_q = pp[BANDWIDTH] * l_qq;
        const T ki_d = kp_d * pp[INV_TI];
        const T ki_q = kp_q * pp[INV_TI];
        const T e_d = op.ref_d - i_d;
        const T e_q = op.ref_q - i_q;
        const T ud_unsat = kp_d * e_d + int_d + op.ff_d - op.omega * psi_q;
        const T uq_unsat = kp_q * e_q + int_q + op.ff_q + op.omega * psi_d;
        // 3. inscribed-circle limit, back-calculation anti-windup
        const T s = vector_scale(ud_unsat, uq_unsat, pp[U_LIM]);
        const T u_d = ud_unsat * s;
        const T u_q = uq_unsat * s;
        const T int_d1 = int_d + ki_d * pp[TAU] * e_d + pp[TAU_TI] * (u_d - ud_unsat);
        const T int_q1 = int_q + ki_q * pp[TAU] * e_q + pp[TAU_TI] * (u_q - uq_unsat);
        const T a_d = (T)2 * (u_d - pp[AMN_D]) * pp[AINV_D] - T(1);
        const T a_q = (T)2 * (u_q - pp[AMN_Q]) * pp[AINV_Q] - T(1);
        const T ap_d = args.delayed ? c[4] : a_d;
        const T ap_q = args.delayed ? c[5] : a_q;
        // 4. predict: one Euler step of the saturated ODE at the applied voltage
        const T u_ap_d = (ap_d + T(1)) * (T)0.5 * pp[ASPAN_D] + pp[AMN_D];
        const T u_ap_q = (ap_q + T(1)) * (T)0.5 * pp[ASPAN_Q] + pp[AMN_Q];
        const T det = l_dd * l_qq - l_dq * l_qd;
        const T inv_dd = l_qq / det, inv_dq = -l_dq / det;
        const T inv_qd = -l_qd / det, inv_qq = l_dd / det;
        const T rhs_d = u_ap_d - pp[R_S] * i_d + op.omega * psi_q;
        const T rhs_q = u_ap_q - pp[R_S] * i_q - op.omega * psi_d;
        const T i_d1 = i_d + pp[TAU] * (inv_dd * rhs_d + inv_dq * rhs_q);
        const T i_q1 = i_q + pp[TAU] * (inv_qd * rhs_d + inv_qq * rhs_q);
        c[0] = (T)2 * (i_d1 - pp[MN_D]) * pp[INV_SPAN_D] - T(1);
        c[1] = (T)2 * (i_q1 - pp[MN_Q]) * pp[INV_SPAN_Q] - T(1);
        c[2] = int_d1;
        c[3] = int_q1;
        if (args.delayed) {
            c[4] = a_d;
            c[5] = a_q;
        }
        a[0] = a_d;
        a[1] = a_q;
    }
};

// ScheduledLaw for a fleet whose drives each hold their own operating point
// (ScheduledSensorlessPolicy with per_drive): the references, the
// feedforwards r_s * i_ref and the speed come from the planes (B,)
// ScheduledSensorlessPolicy.PLANES, and the drive gathers its own slice of
// the schedule (one slice per distinct speed; the kernel stages a block's
// slices in shared memory where its launch ordered the drives by slice),
// loaded once per thread into registers with the slice's index; every other
// constant from the slots.  It reads i_d and i_q of the observation only
// (COLS_CURRENTS): a step builds no torque, no cos/sin eps and no buffer
// column.  The law is ScheduledLaw's.
struct ScheduledDriveLaw {
    static constexpr bool SCHEDULED = true;
    static constexpr bool SLICED = true;
    static constexpr bool PREPARES = true;
    static constexpr int COLUMNS = COLS_CURRENTS;
    enum { P_REF_D, P_REF_Q, P_FF_D, P_FF_Q, P_OMEGA, N_PLANES };
    template <typename T>
    struct Prepared {
        ScheduledLaw::OperatingPoint<T> op;
        int slice;  // the drive's slice of the schedule
        int slot;   // its slot among the block's staged slices, or -1
    };
    template <typename T>
    __device__ __forceinline__ static Prepared<T> prepare(const PmsmClArgs& args, const T*, const T*) {
        // the thread's drive, as pmsm_closed_loop_kernel computes it
        const long long b = drive_of(args, (long long)blockIdx.x * blockDim.x + threadIdx.x);
        const auto plane = [&](int i) { return static_cast<const T*>(args.policy_planes[i])[b]; };
        const int slice = static_cast<const int*>(args.sched_slices)[b];
        Prepared<T> p{{plane(P_REF_D), plane(P_REF_Q), plane(P_FF_D), plane(P_FF_Q), plane(P_OMEGA)}, slice,
                      staged_slot(args, slice)};
        keep(p.op.ref_d);
        keep(p.op.ref_q);
        keep(p.op.ff_d);
        keep(p.op.ff_q);
        keep(p.op.omega);
        return p;
    }
    template <typename T>
    __device__ __forceinline__ static void act(const Prepared<T>& p, const PmsmClArgs& args, const T* pp,
                                               const T (&obs)[MAX_OBS], int, const T* sv, int, T* c, T (&a)[2]) {
        ScheduledLaw::law(p.op, args, pp, obs, sv, c, a);
    }
};

template <typename T>
static int launch_dtype(const PmsmClArgs& args, cudaStream_t stream) {
    switch (args.policy_id) {
        case 1:  // the PPO actor, any magnetics and stage count (pmsm_closed_loop/actor.cu)
            return pmsm_closed_loop_actor(args, sizeof(T) == 4 ? 0 : 1, stream);
        case 0:  // AffinePolicy, any magnetics and stage count (pmsm_closed_loop/affine.cu)
            return pmsm_closed_loop_affine(args, sizeof(T) == 4 ? 0 : 1, stream);
        case 2:  // built for linear magnetics, any stage count
            if (args.saturated) return (int)cudaErrorInvalidValue;
            return launch_stages<T, false, SensorlessLaw>(args, stream);
        case 3:  // built for the saturated drive with a one-stage solver; per drive with planes and slices
            if (!args.saturated || args.n_stages != 1 || args.n_sched != MAX_SCHED) return (int)cudaErrorInvalidValue;
            if (args.n_planes == 0 && args.sched_slices == nullptr) return launch_one<T, 1, true, ScheduledLaw>(args, stream);
            if (args.n_planes != ScheduledDriveLaw::N_PLANES || args.sched_slices == nullptr || args.slice_elems <= 0)
                return (int)cudaErrorInvalidValue;
            return launch_one<T, 1, true, ScheduledDriveLaw>(args, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// The trigonometric identities the kernel relies on, checked on the card
// ---------------------------------------------------------------------------

// sincos_pair's results for n float32 inputs: the caller holds s and c
// against torch.sin/torch.cos of x and of -x, bit for bit.
__global__ void sincos_check_kernel(const float* __restrict__ x, float* __restrict__ s, float* __restrict__ c,
                                    long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float si, co;
        sincos_pair(x[i], si, co);
        s[i] = si;
        c[i] = co;
    }
}

extern "C" int pmsm_closed_loop_sincos(const float* x, float* s, float* c, long long n, void* stream) {
    if (n <= 0) return 0;
    sincos_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, s, c, n);
    return (int)cudaGetLastError();
}

extern "C" int pmsm_closed_loop_args_size() { return (int)sizeof(PmsmClArgs); }

// The fixed slot count of a slot family's flat vector; 0 for the families
// whose vector has a run-time length (AffinePolicy, the actor); -1 for a family
// the kernel is not built with.
extern "C" int pmsm_closed_loop_slots(int policy_id) {
    switch (policy_id) {
        case 0:
        case 1: return 0;
        case 2: return (int)SensorlessLaw::N_SLOTS;
        case 3: return (int)ScheduledLaw::N_SLOTS;
        default: return -1;
    }
}

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success): a refused launch never runs, and only this code reports it.
extern "C" int pmsm_closed_loop_launch(const PmsmClArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    if (args->n_pp > MAX_POLICY_PARAMS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
