// The PMSM drive's electrical model on the device, shared by the open-loop
// kernel (pmsm_stepper.cu) and the closed-loop kernel (pmsm_closed_loop.cu):
// the per-instance constants, the bilinear gather of stacked maps on the
// magnetics table's grid (and of channel-interleaved ones, which both
// kernels read), the saturated and linear vector fields of the currents,
// the torque maps, and the pieces of the inverter constraint the two
// kernels share (the DC-link fold, the sector rotations, the sincos and
// the wrap of the advanced angle).
//
// Every function mirrors the environment's own arithmetic
// (models/pmsm/pmsm_env.py: nonlinear_ode, linear_ode, the torque maps,
// _constrain; ops/lut.py::bilinear_gather; ops/transforms.py) operation for
// operation, in the working precision, under the rules of eager_rules.cuh.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"

#define N_PARAMS 5
#define N_CHANNELS 6
#define N_CHANNELS_PAD 8  // channels of the interleaved table (ops/lut.py::padded_channels)

// parameter slots, in the order of PMSM_PARAMS in ops/kernels/pmsm_stepper.py
enum { P_P = 0, P_RS = 1, P_LD = 2, P_LQ = 3, P_PSI = 4 };

// Per-instance constants, folded once.
template <typename T>
struct Drive {
    T r_s, omega;
    T p15;                  // 3 / 2 * p (== 1.5 * p)
    T l_d, l_q, psi_p, dl;  // linear magnetics; dl = l_d - l_q
    Divisor<T> l_d_div, l_q_div;
    T x0, y0;
    Divisor<T> dx, dy;
    int nx, ny;
};

// Args: a kernel argument struct with param_ptr/param_value (PMSM_PARAMS
// order), omega, and the grid x0, dx, y0, dy, nx, ny.
template <typename T, class Args>
__device__ __forceinline__ Drive<T> prepare(const Args& args, long long b) {
    Weak<T> w[N_PARAMS];
#pragma unroll
    for (int i = 0; i < N_PARAMS; ++i) w[i] = weak_load<T>(args.param_ptr[i], args.param_value[i], b);
    Drive<T> k;
    k.r_s = value(w[P_RS]);
    k.omega = static_cast<const T*>(args.omega)[b];
    k.p15 = value(wmul(weak_const<T>(1.5), w[P_P]));
    k.l_d = value(w[P_LD]);
    k.l_q = value(w[P_LQ]);
    k.psi_p = value(w[P_PSI]);
    k.dl = value(wsub(w[P_LD], w[P_LQ]));
    k.l_d_div = divisor(w[P_LD]);
    k.l_q_div = divisor(w[P_LQ]);
    k.x0 = (T)args.x0;
    k.y0 = (T)args.y0;
    k.dx = divisor(weak_const<T>(args.dx));
    k.dy = divisor(weak_const<T>(args.dy));
    k.nx = args.nx;
    k.ny = args.ny;
    return k;
}

// floor, then torch.clamp to [0, n - 2] (NaN passes), then the conversion
__device__ __forceinline__ int cell(float f, int n) {
    float c = floorf(f);
    if (!isnan(c)) c = fminf(fmaxf(c, 0.0f), (float)(n - 2));
    return (int)c;
}
__device__ __forceinline__ int cell(double f, int n) {
    double c = floor(f);
    if (!isnan(c)) c = fmin(fmax(c, 0.0), (double)(n - 2));
    return (int)c;
}

// A table read: a plain load (shared memory), or through the read-only
// data cache (RO, a table left in device memory).
template <bool RO, typename T>
__device__ __forceinline__ T table_load(const T* p) {
    if (RO) return __ldg(p);
    return *p;
}

// lut.py::bilinear_gather of NC stacked channels (C, nx, ny) at (px, py).
template <int NC, bool RO = false, typename T>
__device__ __forceinline__ void gather_n(const T* __restrict__ lut, const Drive<T>& k, T px, T py, T (&v)[NC]) {
    const T fx = (px - k.x0) / k.dx;
    const T fy = (py - k.y0) / k.dy;
    const int ix = cell(fx, k.nx);
    const int iy = cell(fy, k.ny);
    const T wx = fx - (T)ix;
    const T wy = fy - (T)iy;
    const T owx = T(1) - wx;
    const T owy = T(1) - wy;
    const int plane = k.nx * k.ny;
    const int i00 = ix * k.ny + iy;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const T* p = lut + c * plane + i00;
        const T v00 = table_load<RO>(p), v01 = table_load<RO>(p + 1);
        const T v10 = table_load<RO>(p + k.ny), v11 = table_load<RO>(p + k.ny + 1);
        v[c] = v00 * owx * owy + v01 * owx * wy + v10 * wx * owy + v11 * wx * wy;
    }
}

// A 16-byte vector of T, and its load (plain, or through the read-only
// data cache with RO)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;
    static constexpr int N = 4;
};
template <>
struct Vec16<double> {
    using type = double2;
    static constexpr int N = 2;
};

template <bool RO, typename V>
__device__ __forceinline__ V vec_load(const V* p) {
    if (RO) return __ldg(p);
    return *p;
}

// gather_n over a channel-interleaved table (nx, ny, NCP) (ops/lut.py::
// interleave_channels; NCP a multiple of 4, the table 16-byte aligned):
// each corner's channels come in NCP / Vec16::N 16-byte loads from one
// address.  The offsets, weights and blend are gather_n's, term for term.
template <int NC, int NCP, bool RO = false, typename T>
__device__ __forceinline__ void gather_il(const T* __restrict__ table, const Drive<T>& k, T px, T py,
                                          T (&v)[NC]) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::N;
    constexpr int G = NCP / W;  // vectors per grid point
    static_assert(NCP % 4 == 0 && NC <= NCP, "an interleaved table pads its channels to a multiple of 4");
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
        const V q00 = vec_load<RO>(p00 + g), q01 = vec_load<RO>(p00 + G + g);
        const V q10 = vec_load<RO>(p10 + g), q11 = vec_load<RO>(p10 + G + g);
        const T* c00 = reinterpret_cast<const T*>(&q00);
        const T* c01 = reinterpret_cast<const T*>(&q01);
        const T* c10 = reinterpret_cast<const T*>(&q10);
        const T* c11 = reinterpret_cast<const T*>(&q11);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            if (g * W + w < NC)
                v[g * W + w] = c00[w] * owx * owy + c01[w] * owx * wy + c10[w] * wx * owy + c11[w] * wx * wy;
        }
    }
}

// the six magnetics channels at (i_d, i_q), from the table in shared memory:
// stacked (6, nx, ny), or channel-interleaved (nx, ny, 8) with IL
template <bool IL = false, typename T>
__device__ __forceinline__ void gather(const T* __restrict__ lut, const Drive<T>& k, T i_d, T i_q,
                                       T (&v)[N_CHANNELS]) {
    if (IL)
        gather_il<N_CHANNELS, N_CHANNELS_PAD>(lut, k, i_d, i_q, v);
    else
        gather_n<N_CHANNELS>(lut, k, i_d, i_q, v);
}

// PMSM.nonlinear_ode for the currents, from gathered channels
template <typename T>
__device__ __forceinline__ void saturated_rhs(const T (&v)[N_CHANNELS], const Drive<T>& k, T i_d, T i_q, T u_d,
                                              T u_q, T (&dy)[2]) {
    const T l_dd = v[0], l_dq = v[1], l_qd = v[2], l_qq = v[3], psi_d = v[4], psi_q = v[5];
    const T det = l_dd * l_qq - l_dq * l_qd;
    const T inv_dd = l_qq / det, inv_dq = -l_dq / det;
    const T inv_qd = -l_qd / det, inv_qq = l_dd / det;
    const T rhs_d = u_d - k.r_s * i_d + k.omega * psi_q;
    const T rhs_q = u_q - k.r_s * i_q - k.omega * psi_d;
    dy[0] = inv_dd * rhs_d + inv_dq * rhs_q;
    dy[1] = inv_qd * rhs_d + inv_qq * rhs_q;
}

// PMSM.linear_ode for the currents
template <typename T>
__device__ __forceinline__ void linear_rhs(const Drive<T>& k, T i_d, T i_q, T u_d, T u_q, T (&dy)[2]) {
    dy[0] = (u_d + k.omega * k.l_q * i_q - k.r_s * i_d) / k.l_d_div;
    dy[1] = (u_q - k.omega * (k.l_d * i_d + k.psi_p) - k.r_s * i_q) / k.l_q_div;
}

// PMSM.nonlinear_ode / PMSM.linear_ode for the currents (IL: the table is
// channel-interleaved)
template <typename T, bool SAT, bool IL = false>
__device__ __forceinline__ void ode(const T* lut, const Drive<T>& k, const T (&y)[2], T u_d, T u_q, T (&dy)[2]) {
    if (SAT) {
        T v[N_CHANNELS];
        gather<IL>(lut, k, y[0], y[1], v);
        saturated_rhs(v, k, y[0], y[1], u_d, u_q, dy);
    } else {
        linear_rhs(k, y[0], y[1], u_d, u_q, dy);
    }
}

// PMSM.currents_to_torque_saturated from gathered channels
template <typename T>
__device__ __forceinline__ T saturated_torque(const T (&v)[N_CHANNELS], const Drive<T>& k, T i_d, T i_q) {
    return k.p15 * (v[4] * i_q - v[5] * i_d);
}

// PMSM.currents_to_torque
template <typename T>
__device__ __forceinline__ T linear_torque(const Drive<T>& k, T i_d, T i_q) {
    return k.p15 * (k.psi_p + k.dl * i_d) * i_q;
}

// PMSM.currents_to_torque_saturated / PMSM.currents_to_torque
template <typename T, bool SAT, bool IL = false>
__device__ __forceinline__ T torque(const T* lut, const Drive<T>& k, T i_d, T i_q) {
    if (SAT) {
        T v[N_CHANNELS];
        gather<IL>(lut, k, i_d, i_q, v);
        return saturated_torque(v, k, i_d, i_q);
    }
    return linear_torque(k, i_d, i_q);
}

// ---------------------------------------------------------------------------
// The inverter constraint's shared pieces
// ---------------------------------------------------------------------------

// The DC link of one drive: 1 / (u_dc / 2) and u_dc / 2, folded in double
// for a scalar u_dc as Python folds them; for a per-batch plane u_dc / 2 is
// a multiply by the reciprocal 0.5 and 1 / (...) is Tensor.__rtruediv__'s
// reciprocal (times 1)
template <typename T>
__device__ __forceinline__ void dc_link(const Weak<T>& u_dc, T& inv_half_dc, T& half_dc) {
    if (u_dc.py) {
        inv_half_dc = (T)(1.0 / (u_dc.d / 2.0));
        half_dc = (T)(u_dc.d / 2.0);
    } else {
        half_dc = u_dc.v * (T)0.5;
        inv_half_dc = T(1) / half_dc;
    }
}

// The hexagon's eight sector rotations (ops/transforms.py ROTATION_RE/IM,
// float32 values, indexed b0 * 4 + b1 * 2 + b2) into shared memory: 8 real
// parts, then 8 imaginary ones, in the working type.  Threads 0-7 write;
// the caller synchronizes.
template <typename T>
__device__ __forceinline__ void load_rotations(T* rot, const double* re, const double* im) {
    if (threadIdx.x < 8) {
        rot[threadIdx.x] = (T)re[threadIdx.x];
        rot[8 + threadIdx.x] = (T)im[threadIdx.x];
    }
}

// torch.sin(x) and torch.cos(x): one sincosf in float32, whose results equal
// sinf's and cosf's for every finite |x| < 2^7 (checked exhaustively on the
// card, with sinf(-x) == -sinf(x) and cosf(-x) == cosf(x): chip_smoke.py's
// trig phase and tests/test_torch_gpu.py); the two literal calls in float64
__device__ __forceinline__ void sincos_pair(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void sincos_pair(double x, double& s, double& c) {
    s = sin(x);
    c = cos(x);
}

// The hexagon's two rotations at the advanced angle: cos(-adv), sin(-adv),
// cos(adv), sin(adv).  In float32 from one sincos_pair, with cos(-x) ==
// cos(x) and sin(-x) == -sin(x) (checked with sincos_pair on the card); in
// float64 the four literal calls.
__device__ __forceinline__ void hex_angles(float adv, float& ca, float& sa, float& cb, float& sb) {
    sincos_pair(adv, sb, cb);
    ca = cb;
    sa = -sb;
}
__device__ __forceinline__ void hex_angles(double adv, double& ca, double& sa, double& cb, double& sb) {
    ca = cos(-adv);
    sa = sin(-adv);
    cb = cos(adv);
    sb = sin(adv);
}

// transforms.py::step_eps(eps, omega_el, tau, deadtime + 0.5) with the
// advance adv_inc = omega_el * tau * (deadtime + 0.5) folded by the caller:
// (eps + adv_inc) % 2 pi, then (adv > pi) * (-2 pi) added
template <typename T>
__device__ __forceinline__ T advanced_angle(T eps, T adv_inc) {
    const T two_pi = (T)6.283185307179586;
    T adv = eps + adv_inc;
    adv = floored_mod(adv, two_pi);
    return adv + (adv > (T)3.141592653589793 ? -two_pi : -T(0));
}
