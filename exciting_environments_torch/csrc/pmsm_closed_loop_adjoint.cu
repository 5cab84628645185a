// The reverse sweep of the PMSM closed loop (csrc/pmsm_closed_loop.cu) under
// the affine law (ops/policies.py::AffinePolicy, with or without Ki, no clip)
// and explicit Euler, without noise slabs or schedule: the gradient of the
// loop's outputs with respect to the law's flat gains [K, b, Ki], the five
// start leaves and the carry, for the whole horizon of T steps in one launch.
//
// The forward launch saves every step (i_d, i_q, torque, u_con_d, u_con_q,
// a_d, a_q and the carry, time-major (T, B)); this kernel walks the steps
// backwards, one thread per drive.  Each step is recomputed from its start:
// the saved currents of the step before, the angle of the state-independent
// recurrence (ops/kernels/pmsm_closed_loop.py::_eps_starts, which a prologue
// of this kernel replays per drive into a (T, B) plane), the buffers (with
// deadtime the saved constrained voltages of the step before, else the start
// buffers) and the saved action.  Then the cotangents are pulled back through
//   1. the Euler step i1 = i + tau f(i, u_app): the 2x2 inverse of the
//      gathered differential inductances, the bilinear gathers' slopes in the
//      currents (the table's cell index carries no gradient);
//   2. the deadtime buffers (the buffer drives the step and takes u_con, or
//      u_con drives it);
//   3. the hexagon at the deadtime-advanced angle (the sector and the
//      rotation table carry none; a clamp passes its cotangent where
//      lo <= x <= hi, ties included, as torch.clamp's gradient does);
//   4. the affine law and its integrator, accumulating each drive's part of
//      the gains' gradient in registers;
//   5. the observation's normalization, cos/sin eps and the torque's gather.
// Per-step cotangents that are null read as zero.  The plain version, step
// for step in this order, is ops/kernels/pmsm_closed_loop.py::
// plain_pmsm_cl_adjoint; the same recomputation as the forward kernel's
// arithmetic (the functions of pmsm_drive.cuh and pmsm_closed_loop.cuh), so
// the sectors and clamps the forward took are the ones pulled back through.
//
// The fleet's sum of the gains' gradient uses no floating-point atomics: each
// warp reduces its drives' parts in double by a fixed shuffle tree, each
// block its four warps in order (partials, (blocks, n_pp) double), and a
// second kernel of this launch sums the blocks in order: two runs give the
// same bits.
//
// What bounds it on an H100: operations, a long dependent chain per drive
// (about a thousand a step: two gathers' worth of table reads and slopes,
// the hexagon forward and back, the law's 4 n_obs products and its 2 n_obs + 1
// gains' accumulations), as the forward kernel is.  The table sits in shared
// memory channel-interleaved as the forward reads it, with the flat gains and
// the sector rotations; the state's and the gains' cotangents stay in
// registers for all T steps.  Build with --fmad=false.

#include "pmsm_closed_loop.cuh"

// Mirrored field for field by PmsmClAdjointArgs in ops/kernels/pmsm_closed_loop_adjoint.py.
struct PmsmClAdjointArgs {
    PmsmClArgs fwd;                        // the forward launch's static fields, start leaves, carry, references
    const void* saves[7];                  // (T, B) i_d, i_q, torque, u_con_d, u_con_q, a_d, a_q
    const void* g_traj[7];                 // (T, B) cotangents of the saves, or null
    const void* g_traj_carry[MAX_CARRY];   // (T, B) cotangents of the carry's saves, or null
    const void* g_final[6];                // (B,) i_d, i_q, eps, u_d_buffer, u_q_buffer, torque, or null
    const void* g_u_last[2];               // (B,) the last applied voltage, or null
    const void* g_carry[MAX_CARRY];        // (B,) the final carry, or null
    void* eps;                             // (T, B) scratch: the pre-step angles
    void* g_state0[5];                     // (B,) cotangents of the start leaves
    void* g_carry0[MAX_CARRY];             // (B,) cotangents of the start carry
    void* partials;                        // (blocks, n_pp) double: each block's part of the gains' gradient
    void* g_params;                        // (n_pp,) the gains' gradient
};

#define ADJ_THREADS 128
#define ADJ_WARPS (ADJ_THREADS / 32)
#define MAX_AFFINE_PARAMS (4 * MAX_OBS + 2)

// (T, B) plane p at step t of drive b, or zero for a null plane
template <typename T>
__device__ __forceinline__ T plane_at(const void* p, int t, long long batch, long long b) {
    return p == nullptr ? T(0) : __ldg(static_cast<const T*>(p) + (long long)t * batch + b);
}
template <typename T>
__device__ __forceinline__ T leaf_at(const void* p, long long b) {
    return p == nullptr ? T(0) : static_cast<const T*>(p)[b];
}

// gather_il of the six magnetics channels at (px, py) with their slopes along
// both coordinates: sx = ((v10 - v00)(1 - wy) + (v11 - v01) wy) / dx, sy alike
template <typename T>
__device__ __forceinline__ void gather_slopes(const T* __restrict__ table, const Drive<T>& k, T px, T py,
                                              T (&v)[N_CHANNELS], T (&sx)[N_CHANNELS], T (&sy)[N_CHANNELS]) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::N;
    constexpr int G = N_CHANNELS_PAD / W;
    const T fx = (px - k.x0) / k.dx;
    const T fy = (py - k.y0) / k.dy;
    const int ix = cell(fx, k.nx);
    const int iy = cell(fy, k.ny);
    const T wx = fx - (T)ix;
    const T wy = fy - (T)iy;
    const T owx = T(1) - wx;
    const T owy = T(1) - wy;
    const V* p00 = reinterpret_cast<const V*>(table) + (ix * k.ny + iy) * G;
    const V* p10 = p00 + k.ny * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const V q00 = p00[g], q01 = p00[G + g], q10 = p10[g], q11 = p10[G + g];
        const T* c00 = reinterpret_cast<const T*>(&q00);
        const T* c01 = reinterpret_cast<const T*>(&q01);
        const T* c10 = reinterpret_cast<const T*>(&q10);
        const T* c11 = reinterpret_cast<const T*>(&q11);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const int c = g * W + w;
            if (c < N_CHANNELS) {
                v[c] = c00[w] * owx * owy + c01[w] * owx * wy + c10[w] * wx * owy + c11[w] * wx * wy;
                sx[c] = ((c10[w] - c00[w]) * owy + (c11[w] - c01[w]) * wy) / k.dx;
                sy[c] = ((c01[w] - c00[w]) * owx + (c11[w] - c10[w]) * wx) / k.dy;
            }
        }
    }
}

// The torque's cotangent l_tau at currents (i_d, i_q) pulled back onto them,
// through the gathered fluxes (v, sx, sy) with SAT
template <typename T, bool SAT>
__device__ __forceinline__ void torque_back(const Drive<T>& k, const T (&v)[N_CHANNELS], const T (&sx)[N_CHANNELS],
                                            const T (&sy)[N_CHANNELS], T i_d, T i_q, T l_tau, T& l_id, T& l_iq) {
    if (SAT) {
        const T l_pd = k.p15 * i_q * l_tau, l_pq = -(k.p15 * i_d * l_tau);
        l_id = l_id + (-(k.p15 * v[5] * l_tau) + l_pd * sx[4] + l_pq * sx[5]);
        l_iq = l_iq + (k.p15 * v[4] * l_tau + l_pd * sy[4] + l_pq * sy[5]);
    } else {
        l_id = l_id + k.p15 * k.dl * i_q * l_tau;
        l_iq = l_iq + k.p15 * (k.psi_p + k.dl * i_d) * l_tau;
    }
}

// pmsm_closed_loop.cuh::hex_constrain recomputed, then pulled back: the
// cotangents (l_ucd, l_ucq) of the constrained voltages onto the normalized
// actions (l_ad, l_aq) and the angle (l_adv)
template <typename T>
__device__ __forceinline__ void hex_back(const Bands<T>& k, const T* rot, T a_d, T a_q, T eps, T adv_inc, T l_ucd,
                                         T l_ucq, T& l_ad, T& l_aq, T& l_adv) {
    const T u_d = (a_d + T(1)) * (T)0.5 * k.act_span[0] + k.act_lo[0];
    const T u_q = (a_q + T(1)) * (T)0.5 * k.act_span[1] + k.act_lo[1];
    const T nd = u_d * k.inv_half_dc;
    const T nq = u_q * k.inv_half_dc;
    const T adv = advanced_angle(eps, adv_inc);
    T ca, sa, cb, sb;
    hex_angles(adv, ca, sa, cb, sb);
    const T alpha = ca * nd + sa * nq;
    const T beta = -sa * nd + ca * nq;
    const T s120 = (T)0.8660254037844386;
    const int b0 = beta >= T(0);
    const int b1 = (T)-0.5 * beta - s120 * alpha >= T(0);
    const int b2 = (T)-0.5 * beta + s120 * alpha >= T(0);
    const int idx = b0 * 4 + b1 * 2 + b2;
    const T re = rot[idx], im = rot[8 + idx];
    const T ra = alpha * re - beta * im;
    const T rb = alpha * im + beta * re;
    const T a_lo = (T)(-2.0 / 3.0), a_hi = (T)(2.0 / 3.0), b_hi = (T)(2.0 / 3.0 * 1.7320508075688772);
    const T rac = clampv(ra, a_lo, a_hi);
    const T rbc = clampv(rb, T(0), b_hi);
    const T oa = rac * re + rbc * im;
    const T ob = rbc * re - rac * im;

    const T h = k.half_dc;
    const T l_oa = h * (cb * l_ucd - sb * l_ucq);
    const T l_ob = h * (sb * l_ucd + cb * l_ucq);
    T l = -sb * (h * (oa * l_ucd + ob * l_ucq)) + cb * (h * (ob * l_ucd - oa * l_ucq));
    const T l_ra = (ra >= a_lo && ra <= a_hi) ? re * l_oa - im * l_ob : T(0);
    const T l_rb = (rb >= T(0) && rb <= b_hi) ? im * l_oa + re * l_ob : T(0);
    const T l_alpha = re * l_ra + im * l_rb;
    const T l_beta = -im * l_ra + re * l_rb;
    const T l_nd = ca * l_alpha - sa * l_beta;
    const T l_nq = sa * l_alpha + ca * l_beta;
    l = l + sa * (nd * l_alpha + nq * l_beta) - ca * (nq * l_alpha - nd * l_beta);
    l_adv = l;
    l_ad = l_nd * k.inv_half_dc * (k.act_span[0] / T(2));
    l_aq = l_nq * k.inv_half_dc * (k.act_span[1] / T(2));
}

// double's shuffle down the warp (a fixed tree: the same order every run)
__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
}

template <typename T, bool SAT, bool INTEGRAL, bool DEADTIME>
__global__ void __launch_bounds__(ADJ_THREADS) pmsm_cl_adjoint_kernel(const __grid_constant__ PmsmClAdjointArgs args) {
    const PmsmClArgs& fa = args.fwd;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double warp_part[ADJ_WARPS][MAX_AFFINE_PARAMS];
    T* lut = reinterpret_cast<T*>(smem_raw);
    T* pp = lut + lut_elems(fa, SAT);
    T* rot = pp + fa.n_pp;
    {
        const T* src = static_cast<const T*>(fa.policy_params);
        for (int i = threadIdx.x; i < fa.n_pp; i += blockDim.x) pp[i] = src[i];
        load_rotations(rot, fa.rot_re, fa.rot_im);
        if (SAT) copy_block(lut, fa.lut, lut_elems(fa, SAT));
        __syncthreads();
    }
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long batch = fa.batch;
    const bool active = b < batch;
    const int n_obs = N_BASE_OBS + fa.n_refs;
    const int n_steps = fa.n_steps;

    // each drive's part of the gains' gradient: K (2 x n_obs), b (2), Ki (2 x n_obs)
    T gK[2][MAX_OBS], gb[2], gKi[2][MAX_OBS];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        gb[j] = T(0);
#pragma unroll
        for (int i = 0; i < MAX_OBS; ++i) gK[j][i] = gKi[j][i] = T(0);
    }

    if (active) {
        const Drive<T> k = prepare<T>(fa, b);
        const Bands<T> bd = bands<T>(fa, b);
        T tau = (T)fa.tau;
        keep(tau);
        const T omega = k.omega;
        const T adv_inc = omega * tau * (T)fa.adv_scale;
        const T eps_inc = tau * omega;  // Euler: the angle rate is omega
        const T obs_omega = normalize(bd, 2, omega);
        T ref[MAX_REFS];
#pragma unroll
        for (int r = 0; r < MAX_REFS; ++r) ref[r] = r < fa.n_refs ? static_cast<const T*>(fa.refs[r])[b] : T(0);
        T slope[6];  // d normalize / dx of the six observation bands
#pragma unroll
        for (int i = 0; i < 6; ++i) slope[i] = T(2) / bd.obs_span[i];

        // the pre-step angles, replayed as the forward kernel advances them
        T* eps_plane = static_cast<T*>(args.eps);
        {
            T e = static_cast<const T*>(fa.state0[2])[b];
            for (int t = 0; t < n_steps; ++t) {
                eps_plane[(long long)t * batch + b] = e;
                e = wrap_angle(e + eps_inc);
            }
        }
        const T i_d0 = static_cast<const T*>(fa.state0[0])[b];
        const T i_q0 = static_cast<const T*>(fa.state0[1])[b];
        const T bd0 = static_cast<const T*>(fa.state0[3])[b];
        const T bq0 = static_cast<const T*>(fa.state0[4])[b];

        // the final outputs' cotangents; the final torque and the last save's
        // torque both read the final state
        T l_id = leaf_at<T>(args.g_final[0], b), l_iq = leaf_at<T>(args.g_final[1], b);
        T l_eps = leaf_at<T>(args.g_final[2], b);
        T l_bd = leaf_at<T>(args.g_final[3], b), l_bq = leaf_at<T>(args.g_final[4], b);
        T l_c[2] = {T(0), T(0)};
        if (INTEGRAL) {
            l_c[0] = leaf_at<T>(args.g_carry[0], b);
            l_c[1] = leaf_at<T>(args.g_carry[1], b);
        }
        {
            const T l_tau = leaf_at<T>(args.g_final[5], b) + plane_at<T>(args.g_traj[2], n_steps - 1, batch, b);
            const T f_id = plane_at<T>(args.saves[0], n_steps - 1, batch, b);
            const T f_iq = plane_at<T>(args.saves[1], n_steps - 1, batch, b);
            T v[N_CHANNELS], sx[N_CHANNELS], sy[N_CHANNELS];
            if (SAT) gather_slopes(lut, k, f_id, f_iq, v, sx, sy);
            torque_back<T, SAT>(k, v, sx, sy, f_id, f_iq, l_tau, l_id, l_iq);
        }

        for (int t = n_steps - 1; t >= 0; --t) {
            // the saves of step t: its post-step currents, voltages, actions, carry
            l_id = l_id + plane_at<T>(args.g_traj[0], t, batch, b);
            l_iq = l_iq + plane_at<T>(args.g_traj[1], t, batch, b);
            if (INTEGRAL) {
                l_c[0] = l_c[0] + plane_at<T>(args.g_traj_carry[0], t, batch, b);
                l_c[1] = l_c[1] + plane_at<T>(args.g_traj_carry[1], t, batch, b);
            }
            const T i_d = t == 0 ? i_d0 : plane_at<T>(args.saves[0], t - 1, batch, b);
            const T i_q = t == 0 ? i_q0 : plane_at<T>(args.saves[1], t - 1, batch, b);
            T buf_d = bd0, buf_q = bq0, u_app_d, u_app_q;
            if (DEADTIME) {
                if (t > 0) {
                    buf_d = plane_at<T>(args.saves[3], t - 1, batch, b);
                    buf_q = plane_at<T>(args.saves[4], t - 1, batch, b);
                }
                u_app_d = buf_d;
                u_app_q = buf_q;
            } else {
                u_app_d = plane_at<T>(args.saves[3], t, batch, b);
                u_app_q = plane_at<T>(args.saves[4], t, batch, b);
            }
            const T eps = eps_plane[(long long)t * batch + b];
            const T a_d = plane_at<T>(args.saves[5], t, batch, b);
            const T a_q = plane_at<T>(args.saves[6], t, batch, b);

            // the step's values again: the gather, the torque, the observation
            T v[N_CHANNELS], sx[N_CHANNELS], sy[N_CHANNELS];
            if (SAT) gather_slopes(lut, k, i_d, i_q, v, sx, sy);
            const T trq = SAT ? saturated_torque(v, k, i_d, i_q) : linear_torque(k, i_d, i_q);
            T obs[MAX_OBS];
            obs[0] = normalize(bd, 0, i_d);
            obs[1] = normalize(bd, 1, i_q);
            obs[2] = obs_omega;
            obs[3] = normalize(bd, 3, trq);
            T s_eps, c_eps;
            sincos_pair(eps, s_eps, c_eps);
            obs[4] = c_eps;
            obs[5] = s_eps;
            obs[6] = normalize(bd, 4, buf_d);
            obs[7] = normalize(bd, 5, buf_q);
#pragma unroll
            for (int r = 0; r < MAX_REFS; ++r) obs[N_BASE_OBS + r] = ref[r];

            // 1. the Euler step
            const T l_fd = tau * l_id, l_fq = tau * l_iq;
            T l_v[N_CHANNELS];
            T l_ud, l_uq;
            if (SAT) {
                const T l_dd = v[0], l_dq = v[1], l_qd = v[2], l_qq = v[3], psi_d = v[4], psi_q = v[5];
                const T det = l_dd * l_qq - l_dq * l_qd;
                const T inv_dd = l_qq / det, inv_dq = -l_dq / det;
                const T inv_qd = -l_qd / det, inv_qq = l_dd / det;
                const T rhs_d = u_app_d - k.r_s * i_d + omega * psi_q;
                const T rhs_q = u_app_q - k.r_s * i_q - omega * psi_d;
                const T l_rd = inv_dd * l_fd + inv_qd * l_fq;
                const T l_rq = inv_dq * l_fd + inv_qq * l_fq;
                const T e_dd = rhs_d * l_fd, e_dq = rhs_q * l_fd, e_qd = rhs_d * l_fq, e_qq = rhs_q * l_fq;
                const T l_det = -(e_dd * inv_dd + e_dq * inv_dq + e_qd * inv_qd + e_qq * inv_qq) / det;
                l_v[0] = e_qq / det + l_det * l_qq;
                l_v[1] = -(e_dq / det) - l_det * l_qd;
                l_v[2] = -(e_qd / det) - l_det * l_dq;
                l_v[3] = e_dd / det + l_det * l_dd;
                l_v[4] = -(omega * l_rq);
                l_v[5] = omega * l_rd;
                l_id = l_id - k.r_s * l_rd;
                l_iq = l_iq - k.r_s * l_rq;
                l_ud = l_rd;
                l_uq = l_rq;
            } else {
                l_ud = l_fd / k.l_d_div;
                l_uq = l_fq / k.l_q_div;
                l_id = l_id - k.r_s * l_ud - omega * k.l_d * l_uq;
                l_iq = l_iq + omega * k.l_q * l_ud - k.r_s * l_uq;
            }
            if (t == n_steps - 1) {
                l_ud = l_ud + leaf_at<T>(args.g_u_last[0], b);
                l_uq = l_uq + leaf_at<T>(args.g_u_last[1], b);
            }

            // 2. the deadtime buffers
            T l_ucd, l_ucq;
            if (DEADTIME) {
                l_ucd = plane_at<T>(args.g_traj[3], t, batch, b) + l_bd;
                l_ucq = plane_at<T>(args.g_traj[4], t, batch, b) + l_bq;
                l_bd = l_ud;
                l_bq = l_uq;
            } else {
                l_ucd = plane_at<T>(args.g_traj[3], t, batch, b) + l_ud;
                l_ucq = plane_at<T>(args.g_traj[4], t, batch, b) + l_uq;
            }

            // 3. the hexagon
            T l_a[2], l_adv;
            hex_back(bd, rot, a_d, a_q, eps, adv_inc, l_ucd, l_ucq, l_a[0], l_a[1], l_adv);
            l_a[0] = plane_at<T>(args.g_traj[5], t, batch, b) + l_a[0];
            l_a[1] = plane_at<T>(args.g_traj[6], t, batch, b) + l_a[1];

            // 4. the affine law a = b + K obs (+ c1), c1 = c + Ki obs
            const T* K = pp;
            const T* Ki = pp + 2 * n_obs + 2;
            T l_obs[MAX_OBS];
#pragma unroll
            for (int i = 0; i < MAX_OBS; ++i)
                if (i < n_obs) l_obs[i] = K[i] * l_a[0] + K[n_obs + i] * l_a[1];
            if (INTEGRAL) {
                l_c[0] = l_c[0] + l_a[0];
                l_c[1] = l_c[1] + l_a[1];
#pragma unroll
                for (int i = 0; i < MAX_OBS; ++i)
                    if (i < n_obs) l_obs[i] = l_obs[i] + Ki[i] * l_c[0] + Ki[n_obs + i] * l_c[1];
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                gb[j] = gb[j] + l_a[j];
#pragma unroll
                for (int i = 0; i < MAX_OBS; ++i) {
                    if (i < n_obs) {
                        gK[j][i] = gK[j][i] + l_a[j] * obs[i];
                        if (INTEGRAL) gKi[j][i] = gKi[j][i] + l_c[j] * obs[i];
                    }
                }
            }

            // 5. the observation, then the torque's gather and the step's own
            l_id = l_id + l_obs[0] * slope[0];
            l_iq = l_iq + l_obs[1] * slope[1];
            l_eps = l_eps + l_adv - s_eps * l_obs[4] + c_eps * l_obs[5];
            l_bd = l_bd + l_obs[6] * slope[4];
            l_bq = l_bq + l_obs[7] * slope[5];
            const T l_tau = l_obs[3] * slope[3] + (t > 0 ? plane_at<T>(args.g_traj[2], t - 1, batch, b) : T(0));
            if (SAT) {
                l_v[4] = l_v[4] + k.p15 * i_q * l_tau;
                l_v[5] = l_v[5] - k.p15 * i_d * l_tau;
                T gx = l_v[0] * sx[0], gy = l_v[0] * sy[0];
#pragma unroll
                for (int c = 1; c < N_CHANNELS; ++c) {
                    gx = gx + l_v[c] * sx[c];
                    gy = gy + l_v[c] * sy[c];
                }
                l_id = l_id - k.p15 * v[5] * l_tau + gx;
                l_iq = l_iq + k.p15 * v[4] * l_tau + gy;
            } else {
                torque_back<T, SAT>(k, v, sx, sy, i_d, i_q, l_tau, l_id, l_iq);
            }
        }

        static_cast<T*>(args.g_state0[0])[b] = l_id;
        static_cast<T*>(args.g_state0[1])[b] = l_iq;
        static_cast<T*>(args.g_state0[2])[b] = l_eps;
        static_cast<T*>(args.g_state0[3])[b] = l_bd;
        static_cast<T*>(args.g_state0[4])[b] = l_bq;
        if (INTEGRAL) {
            static_cast<T*>(args.g_carry0[0])[b] = l_c[0];
            static_cast<T*>(args.g_carry0[1])[b] = l_c[1];
        }
    }

    // the block's part of the gains' gradient, in the flat order K, b, Ki
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < MAX_OBS; ++i) {
            if (i < n_obs) {
                const double s = warp_sum((double)gK[j][i]);
                if (lane == 0) warp_part[warp][j * n_obs + i] = s;
                if (INTEGRAL) {
                    const double si = warp_sum((double)gKi[j][i]);
                    if (lane == 0) warp_part[warp][2 * n_obs + 2 + j * n_obs + i] = si;
                }
            }
        }
        const double sb = warp_sum((double)gb[j]);
        if (lane == 0) warp_part[warp][2 * n_obs + j] = sb;
    }
    __syncthreads();
    if (threadIdx.x < fa.n_pp) {
        double s = warp_part[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < ADJ_WARPS; ++w) s += warp_part[w][threadIdx.x];
        static_cast<double*>(args.partials)[(long long)blockIdx.x * fa.n_pp + threadIdx.x] = s;
    }
}

// The gains' gradient: the blocks' partials summed in block order
template <typename T>
__global__ void pmsm_cl_adjoint_sum(const __grid_constant__ PmsmClAdjointArgs args, int blocks) {
    const int j = threadIdx.x;
    const int n_pp = args.fwd.n_pp;
    if (j >= n_pp) return;
    const double* part = static_cast<const double*>(args.partials);
    double s = 0.0;
    for (int blk = 0; blk < blocks; ++blk) s += part[(long long)blk * n_pp + j];
    static_cast<T*>(args.g_params)[j] = (T)s;
}

template <typename T, bool SAT, bool INTEGRAL, bool DEADTIME>
static int launch_adjoint(const PmsmClAdjointArgs& args, cudaStream_t stream) {
    const PmsmClArgs& fa = args.fwd;
    const size_t smem = (lut_elems(fa, SAT) + (size_t)fa.n_pp + 16) * sizeof(T);
    // above 48 KB of dynamic and static shared memory together a launch is
    // refused unless the kernel opts in (the warps' partial sums are static)
    if (smem + sizeof(double) * ADJ_WARPS * MAX_AFFINE_PARAMS > STATIC_SMEM_LIMIT) {
        const cudaError_t err = cudaFuncSetAttribute(pmsm_cl_adjoint_kernel<T, SAT, INTEGRAL, DEADTIME>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return (int)err;
        }
    }
    const int blocks = (int)((fa.batch + ADJ_THREADS - 1) / ADJ_THREADS);
    pmsm_cl_adjoint_kernel<T, SAT, INTEGRAL, DEADTIME><<<blocks, ADJ_THREADS, smem, stream>>>(args);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pmsm_cl_adjoint_sum<T><<<1, MAX_AFFINE_PARAMS, 0, stream>>>(args, blocks);
    return (int)cudaGetLastError();
}

template <typename T, bool SAT>
static int launch_sat(const PmsmClAdjointArgs& args, cudaStream_t stream) {
    const bool integral = args.fwd.has_integral != 0, deadtime = args.fwd.deadtime != 0;
    if (integral)
        return deadtime ? launch_adjoint<T, SAT, true, true>(args, stream) : launch_adjoint<T, SAT, true, false>(args, stream);
    return deadtime ? launch_adjoint<T, SAT, false, true>(args, stream) : launch_adjoint<T, SAT, false, false>(args, stream);
}

template <typename T>
static int launch_dtype(const PmsmClAdjointArgs& args, cudaStream_t stream) {
    return args.fwd.saturated ? launch_sat<T, true>(args, stream) : launch_sat<T, false>(args, stream);
}

extern "C" int pmsm_closed_loop_adjoint_args_size() { return (int)sizeof(PmsmClAdjointArgs); }

// dtype: 0 float32, 1 float64.  Returns the CUDA error of the launch (0 on
// success).  The scope (the affine law without clip, Euler, no slabs, no
// schedule, 1..4 references) is checked here too: a launch out of it is refused.
extern "C" int pmsm_closed_loop_adjoint_launch(const PmsmClAdjointArgs* args, int dtype, void* stream) {
    const PmsmClArgs& fa = args->fwd;
    if (fa.batch <= 0 || fa.n_steps <= 0) return 0;
    const int n_obs = N_BASE_OBS + fa.n_refs;
    const int n_pp = 2 * n_obs + 2 + (fa.has_integral ? 2 * n_obs : 0);
    if (fa.policy_id != 0 || fa.has_clip || fa.n_stages != 1 || fa.n_refs < 0 || fa.n_refs > MAX_REFS ||
        fa.n_pp != n_pp || fa.n_carry != (fa.has_integral ? 2 : 0) || fa.n_obs_noise || fa.n_proc_noise ||
        fa.n_sched || (fa.deadtime != 0 && fa.deadtime != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 0 ? launch_dtype<float>(*args, s) : launch_dtype<double>(*args, s);
}
