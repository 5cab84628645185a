// Vector fields of the classic ODE environments, shared by the open-loop
// stepper kernel (stepper.cu) and the closed-loop kernel (closed_loop.cu).
//
// Every functor mirrors the environment's _ode in
// exciting_environments_torch/models/ operation for operation, in the working
// precision, so that a kernel agrees bit for bit with its plain PyTorch
// version on the card (see eager_rules.cuh).  The functors of environments
// with trigonometry take a math policy: ExactMath (torch.sin, torch.cos,
// torch.sign and the solver step's floored-remainder wrap) or FastMath (the
// environment's fast_math=True: sin_wrapped, poly_cos, fast_sign and
// wrap_angle_fast of fastmath.cuh).  The kernels wrap angles with
// Env::Math::wrap.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"
#include "fastmath.cuh"

// The static parameters of one instance: parameter i is element b of the
// per-batch (B,) leaf ptr[i], or the host scalar value[i] where ptr[i] is null.
struct ParamView {
    const double* value;
    const void* const* ptr;
};

template <typename T>
__device__ __forceinline__ Weak<T> param(const ParamView& p, int i, long long b) {
    return weak_load<T>(p.ptr[i], p.value[i], b);
}

// torch.sign: (0 < x) - (x < 0)
template <typename T>
__device__ __forceinline__ T dsign(T x) { return (T)((T(0) < x) - (x < T(0))); }

// The environments' _sin/_cos/_sign and _wrap_angles, exact
struct ExactMath {
    template <typename T>
    __device__ __forceinline__ static T sin(T x) { return dsin(x); }
    template <typename T>
    __device__ __forceinline__ static T cos(T x) { return dcos(x); }
    template <typename T>
    __device__ __forceinline__ static T sign(T x) { return dsign(x); }
    template <typename T>
    __device__ __forceinline__ static T wrap(T x) { return wrap_angle(x); }
};

// ... with fast_math=True (core/classic.py)
struct FastMath {
    template <typename T>
    __device__ __forceinline__ static T sin(T x) { return sin_wrapped(x); }
    template <typename T>
    __device__ __forceinline__ static T cos(T x) { return poly_cos(x); }
    template <typename T>
    __device__ __forceinline__ static T sign(T x) { return fast_sign(x); }
    template <typename T>
    __device__ __forceinline__ static T wrap(T x) { return wrap_angle_fast(x); }
};

// core/classic.py::svm_circle, the induction machine's and the EESM's
// inverter limit: scale the physical pair (u_d, u_q) into the circle of
// radius lim (a Python float),
//   mag = sqrt(u_d^2 + u_q^2); s = clamp(lim / clamp(mag, min=1e-12), max=1)
// with lim / tensor by rdiv's rule
template <typename T>
__device__ __forceinline__ void svm_circle(T& u_d, T& u_q, T lim) {
    const T mag = dsqrt(u_d * u_d + u_q * u_q);
    const T s = clamp_max((T(1) / clamp_min(mag, (T)1e-12)) * lim, T(1));
    u_d = u_d * s;
    u_q = u_q * s;
}

// ---------------------------------------------------------------------------
// Environment functors.  prepare() folds the parameters once per instance
// (Weak: scalar parameters in double, as Python folds them); ode() mirrors
// the environment's _ode operation for operation; clip() is the post-step
// saturation hook (_clip_state), the identity but for the fluid tank; Math
// is the policy of the environment's sin/cos/sign and angle wrap.
// ---------------------------------------------------------------------------

// models/pendulum.py::_ode, parameters (l, m, g)
template <class M>
struct PendulumEnv {
    using Math = M;
    static constexpr int N_STATE = 2;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        T lmg;           // params.l * params.m * params.g
        Divisor<T> ml2;  // params.m * (params.l) ** 2
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> l = param<T>(p, 0, b), m = param<T>(p, 1, b), g = param<T>(p, 2, b);
        Consts<T> k;
        k.lmg = value(wmul(wmul(l, m), g));
        k.ml2 = divisor(wmul(m, wmul(l, l)));
        return k;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& k, const T* y, const T* u, T* dy) {
        dy[0] = y[1];
        dy[1] = (u[0] + k.lmg * M::sin(y[0])) / k.ml2;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/mass_spring_damper.py::_ode, parameters (d, k, m); no trigonometry
// and no angle, so fast_math changes nothing
struct MassSpringDamperEnv {
    using Math = ExactMath;
    static constexpr int N_STATE = 2;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        T d, k;
        Divisor<T> m;
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        Consts<T> c;
        c.d = value(param<T>(p, 0, b));
        c.k = value(param<T>(p, 1, b));
        c.m = divisor(param<T>(p, 2, b));
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        dy[0] = y[1];
        dy[1] = ((u[0] - c.d * y[1]) - c.k * y[0]) / c.m;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/cart_pole.py::_ode, parameters (mu_p, mu_c, l, m_p, m_c, g)
template <class M>
struct CartPoleEnv {
    using Math = M;
    static constexpr int N_STATE = 4;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        T mu_p, mu_c, l, m_p, g;
        T mp_l;             // params.m_p * params.l
        Divisor<T> mp_l_d;  // ... as a divisor
        Divisor<T> mc_mp;   // params.m_c + params.m_p
        T four_thirds;
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> mu_p = param<T>(p, 0, b), mu_c = param<T>(p, 1, b), l = param<T>(p, 2, b),
                      m_p = param<T>(p, 3, b), m_c = param<T>(p, 4, b), g = param<T>(p, 5, b);
        Consts<T> c;
        c.mu_p = value(mu_p);
        c.mu_c = value(mu_c);
        c.l = value(l);
        c.m_p = value(m_p);
        c.g = value(g);
        c.mp_l = value(wmul(m_p, l));
        c.mp_l_d = divisor(wmul(m_p, l));
        c.mc_mp = divisor(wadd(m_c, m_p));
        c.four_thirds = (T)(4.0 / 3.0);
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        const T velocity = y[1], theta = y[2], omega = y[3];
        const T s = M::sin(theta), co = M::cos(theta), sg = M::sign(velocity);
        const T om2 = omega * omega;
        const T inner = (((-u[0]) - (c.mp_l * om2) * s) + c.mu_c * sg) / c.mc_mp;
        const T num = ((c.g * s) + co * inner) - (c.mu_p * omega) / c.mp_l_d;
        const T den = c.l * (c.four_thirds - (c.m_p * (co * co)) / c.mc_mp);
        const T d_omega = num / den;
        const T d_velocity = ((u[0] + c.mp_l * ((om2 * s) - d_omega * co)) - c.mu_c * sg) / c.mc_mp;
        dy[0] = velocity;
        dy[1] = d_velocity;
        dy[2] = omega;
        dy[3] = d_omega;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/van_der_pol.py::_ode, parameter (mu)
struct VanDerPolEnv {
    using Math = ExactMath;
    static constexpr int N_STATE = 2;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        T mu;
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        Consts<T> c;
        c.mu = value(param<T>(p, 0, b));
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        dy[0] = y[1];
        dy[1] = ((c.mu * (T(1) - y[0] * y[0])) * y[1] - y[0]) + u[0];
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/fluid_tank.py::_ode and _clip_state, parameters (base_area,
// orifice_area, c_d, g): the height clamped at zero inside the vector field
// and after each step
struct FluidTankEnv {
    using Math = ExactMath;
    static constexpr int N_STATE = 1;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        Divisor<T> area;  // params.base_area
        T outflow;        // params.c_d * params.orifice_area / params.base_area
        T two_g;          // 2 * params.g
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> area = param<T>(p, 0, b), orifice = param<T>(p, 1, b), c_d = param<T>(p, 2, b),
                      g = param<T>(p, 3, b);
        Consts<T> c;
        c.area = divisor(area);
        c.outflow = value(wdiv(wmul(c_d, orifice), area));
        c.two_g = value(wmul(weak_const<T>(2.0), g));
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        const T h = clamp_min(y[0], T(0));
        dy[0] = u[0] / c.area - c.outflow * dsqrt(c.two_g * h);
    }
    template <typename T>
    __device__ static void clip(T* y) { y[0] = clamp_min(y[0], T(0)); }
};

// models/acrobot.py::_ode, parameters (g, l_1, l_2, m_1, m_2, l_c1, l_c2,
// I_1, I_2); l_2 does not enter the vector field
template <class M>
struct AcrobotEnv {
    using Math = M;
    static constexpr int N_STATE = 4;
    static constexpr int N_ACTION = 1;
    template <typename T>
    struct Consts {
        T m1lc1_2;      // m_1 * l_c1**2
        T m2;           // m_2
        T l1_2_lc2_2;   // l_1**2 + l_c2**2
        T two_l1_lc2;   // 2 * l_1 * l_c2
        T i1, i2;       // I_1, I_2
        T lc2_2;        // l_c2**2
        T l1_lc2;       // l_1 * l_c2
        T d22;          // m_2 * l_c2**2 + I_2
        bool d22_py;    // ... a Python number (divided by rdiv's rule)
        T neg_m2l1lc2;  // -m_2 * l_1 * l_c2
        T two_m2l1lc2;  // 2 * m_2 * l_1 * l_c2
        T m2l1lc2;      // m_2 * l_1 * l_c2
        T phi1;         // (m_1 * l_c1 + m_2 * l_1) * g
        T phi2;         // m_2 * l_c2 * g
        T half_pi;      // math.pi / 2
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> g = param<T>(p, 0, b), l1 = param<T>(p, 1, b), m1 = param<T>(p, 3, b),
                      m2 = param<T>(p, 4, b), lc1 = param<T>(p, 5, b), lc2 = param<T>(p, 6, b),
                      i1 = param<T>(p, 7, b), i2 = param<T>(p, 8, b);
        const Weak<T> two = weak_const<T>(2.0);
        Consts<T> c;
        c.m1lc1_2 = value(wmul(m1, wsq(lc1)));
        c.m2 = value(m2);
        c.l1_2_lc2_2 = value(wadd(wsq(l1), wsq(lc2)));
        c.two_l1_lc2 = value(wmul(wmul(two, l1), lc2));
        c.i1 = value(i1);
        c.i2 = value(i2);
        c.lc2_2 = value(wsq(lc2));
        c.l1_lc2 = value(wmul(l1, lc2));
        const Weak<T> d22 = wadd(wmul(m2, wsq(lc2)), i2);
        c.d22 = value(d22);
        c.d22_py = d22.py;
        c.neg_m2l1lc2 = value(wmul(wmul(wneg(m2), l1), lc2));
        c.two_m2l1lc2 = value(wmul(wmul(wmul(two, m2), l1), lc2));
        c.m2l1lc2 = value(wmul(wmul(m2, l1), lc2));
        c.phi1 = value(wmul(wadd(wmul(m1, lc1), wmul(m2, l1)), g));
        c.phi2 = value(wmul(wmul(m2, lc2), g));
        c.half_pi = (T)(3.141592653589793 / 2.0);
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        const T th1 = y[0], th2 = y[1], w1 = y[2], w2 = y[3];
        const T c2 = M::cos(th2), s2 = M::sin(th2);
        const T d11 = ((c.m1lc1_2 + c.m2 * (c.l1_2_lc2_2 + c.two_l1_lc2 * c2)) + c.i1) + c.i2;
        const T d12 = c.m2 * (c.lc2_2 + c.l1_lc2 * c2) + c.i2;
        const T h1 = (c.neg_m2l1lc2 * s2) * (w2 * w2) - ((c.two_m2l1lc2 * s2) * w1) * w2;
        const T h2 = (c.m2l1lc2 * s2) * (w1 * w1);
        const T c12 = M::cos((th1 + th2) + c.half_pi);
        const T phi1 = c.phi1 * M::cos(th1 + c.half_pi) + c.phi2 * c12;
        const T phi2 = c.phi2 * c12;
        const T q = c.d22_py ? (T(1) / d12) * c.d22 : c.d22 / d12;  // d_22 / d_12
        const T dw1 = (T(1) / (d12 - q * d11)) * (((u[0] + q * (h1 + phi1)) - h2) - phi2);
        const T dw2 = (((-d11) * dw1 - h1) - phi1) / d12;
        dy[0] = w1;
        dy[1] = w2;
        dy[2] = dw1;
        dy[3] = dw2;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/induction_machine.py::_ode, parameters (r_s, r_r, l_m, l_s, l_r, p,
// omega)
struct InductionMachineEnv {
    using Math = ExactMath;
    static constexpr int N_STATE = 4;
    static constexpr int N_ACTION = 2;
    template <typename T>
    struct Consts {
        T k_r, r_over_l, r_sig, l_m, omega;
        Divisor<T> sigma_l_s;
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> r_s = param<T>(p, 0, b), r_r = param<T>(p, 1, b), l_m = param<T>(p, 2, b),
                      l_s = param<T>(p, 3, b), l_r = param<T>(p, 4, b), omega = param<T>(p, 6, b);
        const Weak<T> k_r = wdiv(l_m, l_r);
        Consts<T> c;
        c.k_r = value(k_r);
        c.r_over_l = value(wdiv(r_r, l_r));
        c.sigma_l_s = divisor(wsub(l_s, wmul(l_m, k_r)));
        c.r_sig = value(wadd(r_s, wmul(wmul(k_r, k_r), r_r)));
        c.l_m = value(l_m);
        c.omega = value(omega);
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        const T i_sd = y[0], i_sq = y[1], psi_rd = y[2], psi_rq = y[3];
        dy[0] = ((u[0] - c.r_sig * i_sd) + c.k_r * (c.r_over_l * psi_rd + c.omega * psi_rq)) / c.sigma_l_s;
        dy[1] = ((u[1] - c.r_sig * i_sq) + c.k_r * (c.r_over_l * psi_rq - c.omega * psi_rd)) / c.sigma_l_s;
        dy[2] = c.r_over_l * (c.l_m * i_sd - psi_rd) - c.omega * psi_rq;
        dy[3] = c.r_over_l * (c.l_m * i_sq - psi_rq) + c.omega * psi_rd;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/eesm.py::_ode, parameters (r_s, r_f, l_d, l_q, l_f, l_m, p,
// omega_el)
struct EESMEnv {
    using Math = ExactMath;
    static constexpr int N_STATE = 3;
    static constexpr int N_ACTION = 3;
    template <typename T>
    struct Consts {
        T r_s, r_f, l_d, l_f, l_m, omega, omega_lq;
        Divisor<T> det, l_q;
    };
    template <typename T>
    __device__ static Consts<T> prepare(const ParamView& p, long long b) {
        const Weak<T> r_s = param<T>(p, 0, b), r_f = param<T>(p, 1, b), l_d = param<T>(p, 2, b),
                      l_q = param<T>(p, 3, b), l_f = param<T>(p, 4, b), l_m = param<T>(p, 5, b),
                      omega = param<T>(p, 7, b);
        Consts<T> c;
        c.r_s = value(r_s);
        c.r_f = value(r_f);
        c.l_d = value(l_d);
        c.l_f = value(l_f);
        c.l_m = value(l_m);
        c.omega = value(omega);
        c.omega_lq = value(wmul(omega, l_q));
        c.det = divisor(wsub(wmul(l_d, l_f), wmul(l_m, l_m)));
        c.l_q = divisor(l_q);
        return c;
    }
    template <typename T>
    __device__ static void ode(const Consts<T>& c, const T* y, const T* u, T* dy) {
        const T i_d = y[0], i_q = y[1], i_f = y[2];
        const T p_d = (u[0] - c.r_s * i_d) + c.omega_lq * i_q;
        const T p_q = (u[1] - c.r_s * i_q) - c.omega * (c.l_d * i_d + c.l_m * i_f);
        const T p_f = u[2] - c.r_f * i_f;
        dy[0] = (c.l_f * p_d - c.l_m * p_f) / c.det;
        dy[1] = p_q / c.l_q;
        dy[2] = (c.l_d * p_f - c.l_m * p_d) / c.det;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};
