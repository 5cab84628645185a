// Vector fields of the classic ODE environments, shared by the open-loop
// stepper kernel (stepper.cu) and the closed-loop kernel (closed_loop.cu).
//
// Every functor mirrors the environment's _ode in
// exciting_environments_torch/models/ operation for operation, in the working
// precision, so that a kernel agrees bit for bit with its plain PyTorch
// version on the card (see eager_rules.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"

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

// ---------------------------------------------------------------------------
// Environment functors.  prepare() folds the parameters once per instance;
// ode() mirrors the environment's _ode operation for operation; clip() is the
// post-step saturation hook (_clip_state), the identity for these three.
// ---------------------------------------------------------------------------

// models/pendulum.py::_ode, parameters (l, m, g)
struct PendulumEnv {
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
        dy[1] = (u[0] + k.lmg * dsin(y[0])) / k.ml2;
    }
    template <typename T>
    __device__ static void clip(T*) {}
};

// models/mass_spring_damper.py::_ode, parameters (d, k, m)
struct MassSpringDamperEnv {
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
struct CartPoleEnv {
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
        const T s = dsin(theta), co = dcos(theta), sg = dsign(velocity);
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
