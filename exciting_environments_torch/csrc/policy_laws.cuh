// Policy functors shared by the closed-loop kernels (closed_loop.cu for the
// classic environments, pmsm_closed_loop.cu for the PMSM drive).
//
// AffineLaw's act<T, A, MAX_N>(args, pp, obs, n_obs, t, carry, a) reads the
// flat parameters pp (in shared memory), the n_obs observation columns obs
// (at most MAX_N, the size of the caller's register array), updates the
// policy carry in place and writes the A normalized actions.  The PPO actor
// (ActorReg, ActorLaw) has a prepare step as well: prepare<T, A>(args, pp,
// carry) runs once per thread before the time loop and returns what the
// functor keeps in registers, act<T, A, NO>(prepared, args, pp, obs, n_obs,
// t, carry, a) runs per step.  Args is the calling kernel's argument struct;
// a functor reads only the option fields it names (has_integral, has_clip,
// clip; the actor's deterministic, n_layers, widths).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eager_rules.cuh"

// the actor at run-time widths: at most MAX_LAYERS layers of MAX_WIDTH
#define MAX_LAYERS 4
#define MAX_WIDTH 64

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return tanh(x); }

// ---------------------------------------------------------------------------
// The counter-hash normal draw of utils/rl_fused.py::_hash_normal
// ---------------------------------------------------------------------------

// murmur3 finalizer (_mix32) on uint32: wrap-around multiplies, logical shifts
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    h ^= h >> 16;
    return h;
}

// Box-Muller over two mixed 24-bit uniforms of (id, t, j, seed).  The
// multipliers are utils/rl_fused.py's signed int32 constants as uint32
// (_KNUTH, _SEED_MUL, _SALT; tests/test_torch_rl_fused.py pins them).
template <typename T>
__device__ __forceinline__ T hash_normal(int id, int t, int j, int seed) {
    const uint32_t h0 = (uint32_t)id * 0x9e3779b1u + ((uint32_t)t + 1u) * 40503u + (uint32_t)(j * 7919)
                        + (uint32_t)seed * 0x85ebca77u;
    const uint32_t u1b = mix32(h0) >> 8;
    const uint32_t u2b = mix32(h0 ^ 0x3c6ef35fu) >> 8;
    const T u1 = (T)(int)u1b * (T)5.9604644775390625e-08 + (T)2.98023223876953125e-08;  // 2**-24, 2**-25
    const T u2 = (T)(int)u2b * (T)5.9604644775390625e-08;
    return dsqrt((T)-2.0 * dlog(u1)) * dcos((T)6.283185307179586 * u2);
}

// Four values from 16-byte-aligned shared memory: one LDS.128 in float32,
// two in float64
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
    if constexpr (sizeof(T) == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
        const double2 q0 = reinterpret_cast<const double2*>(p)[0];
        const double2 q1 = reinterpret_cast<const double2*>(p)[1];
        v[0] = q0.x;
        v[1] = q0.y;
        v[2] = q1.x;
        v[3] = q1.y;
    }
}

// ---------------------------------------------------------------------------
// Policy functors
// ---------------------------------------------------------------------------

// ops/policies.py::AffinePolicy; pp = K (A x n_obs), b (A), [Ki (A x n_obs)]
struct AffineLaw {
    template <typename T, int A, int MAX_N, class Args>
    __device__ __forceinline__ static void act(const Args& args, const T* pp, const T* obs, int n_obs, int,
                                               T* carry, T* a) {
        const T* K = pp;
        const T* bias = pp + A * n_obs;
        const T* Ki = bias + A;
#pragma unroll
        for (int j = 0; j < A; ++j) {
            T acc = bias[j];
#pragma unroll
            for (int i = 0; i < MAX_N; ++i)
                if (i < n_obs) acc = acc + K[j * n_obs + i] * obs[i];
            if (args.has_integral) {
                T c = carry[j];
#pragma unroll
                for (int i = 0; i < MAX_N; ++i)
                    if (i < n_obs) c = c + Ki[j * n_obs + i] * obs[i];
                carry[j] = c;
                acc = acc + c;
            }
            if (args.has_clip) acc = clampv(acc, (T)(-args.clip), (T)args.clip);
            a[j] = acc;
        }
    }
};

// utils/rl_fused.py::make_actor_tile with two hidden layers of the
// compile-time widths H1 and H2 (N_CARRY: the size of the kernel's carry
// registers, prepare/act as in closed_loop.cuh); pp = per layer w (m x n, [i][j]) and b (n),
// then log_std (A), then the float-encoded seed; carry[0] is the instance
// id.  Activations in registers; weights read from shared memory as
// 16-byte vectors (the layer offsets are multiples of 4 elements).
template <int H1, int H2>
struct ActorReg {
    static_assert(H1 % 4 == 0 && H2 % 4 == 0, "hidden widths are read in 16-byte vectors");
    static constexpr int N_CARRY = 4;
    template <typename T, int A>
    struct Prepared {
        int n_in;
        int o_b0, o_w1, o_b1, o_w2, o_b2;  // offsets in pp
        T std[A];                          // exp(log_std)
        int id, seed;
        unsigned explore;
    };
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args& args, const T* pp, const T* carry) {
        Prepared<T, A> p;
        p.n_in = args.widths[0];
        p.o_b0 = p.n_in * H1;
        p.o_w1 = p.o_b0 + H1;
        p.o_b1 = p.o_w1 + H1 * H2;
        p.o_w2 = p.o_b1 + H2;
        p.o_b2 = p.o_w2 + H2 * A;
        const int o_std = p.o_b2 + A;
#pragma unroll
        for (int j = 0; j < A; ++j) {
            p.std[j] = dexp(pp[o_std + j]);
            keep(p.std[j]);
        }
        p.seed = (int)pp[o_std + A];
        p.id = (int)carry[0];  // the id carry never changes
        p.explore = args.deterministic == 0;
        keep(p.explore);
        return p;
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>& p, const Args&, const T* pp,
                                               const T (&obs)[NO], int, int t, T*, T (&a)[A]) {
        T v[4];
        // hidden layer 1: acc[j] = b[j] + w[0][j] * obs[0] + w[1][j] * obs[1] + ...
        T h1[H1];
#pragma unroll
        for (int j = 0; j < H1; j += 4) {
            load4(pp + p.o_b0 + j, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) h1[j + q] = v[q];
        }
#pragma unroll
        for (int i = 0; i < NO; ++i) {
            if (i < p.n_in) {
                const T x = obs[i];
#pragma unroll
                for (int j = 0; j < H1; j += 4) {
                    load4(pp + i * H1 + j, v);
#pragma unroll
                    for (int q = 0; q < 4; ++q) h1[j + q] = h1[j + q] + v[q] * x;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < H1; ++j) h1[j] = dtanh(h1[j]);
        // hidden layer 2
        T h2[H2];
#pragma unroll
        for (int k = 0; k < H2; k += 4) {
            load4(pp + p.o_b1 + k, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) h2[k + q] = v[q];
        }
#pragma unroll
        for (int j = 0; j < H1; ++j) {
#pragma unroll
            for (int k = 0; k < H2; k += 4) {
                load4(pp + p.o_w1 + j * H2 + k, v);
#pragma unroll
                for (int q = 0; q < 4; ++q) h2[k + q] = h2[k + q] + v[q] * h1[j];
            }
        }
#pragma unroll
        for (int k = 0; k < H2; ++k) h2[k] = dtanh(h2[k]);
        // the linear head, then the exploration draw and the clamp
#pragma unroll
        for (int j = 0; j < A; ++j) {
            T acc = pp[p.o_b2 + j];
#pragma unroll
            for (int k = 0; k < H2; ++k) acc = acc + pp[p.o_w2 + k * A + j] * h2[k];
            if (p.explore) acc = acc + p.std[j] * hash_normal<T>(p.id, t, j, p.seed);
            a[j] = clampv(acc, T(-1), T(1));
        }
    }
};

// The actor at run-time widths (up to MAX_LAYERS layers of MAX_WIDTH): its
// activations are indexed at run time and live in local memory
struct ActorLaw {
    static constexpr int N_CARRY = 4;
    template <typename T, int A>
    struct Prepared {};
    template <typename T, int A, class Args>
    __device__ __forceinline__ static Prepared<T, A> prepare(const Args&, const T*, const T*) {
        return {};
    }
    template <typename T, int A, int NO, class Args>
    __device__ __forceinline__ static void act(const Prepared<T, A>&, const Args& args, const T* pp,
                                               const T (&obs)[NO], int n_obs, int t, T* carry, T (&a)[A]) {
        T h[MAX_WIDTH], out[MAX_WIDTH];
        for (int i = 0; i < n_obs; ++i) h[i] = obs[i];
        int off = 0;
        for (int l = 0; l < args.n_layers; ++l) {
            const int m = args.widths[l], n = args.widths[l + 1];
            const T* w = pp + off;
            const T* bias = w + m * n;
            const bool hidden = l < args.n_layers - 1;
            for (int j = 0; j < n; ++j) {
                T acc = bias[j];
                for (int i = 0; i < m; ++i) acc = acc + w[i * n + j] * h[i];
                out[j] = hidden ? dtanh(acc) : acc;
            }
            for (int j = 0; j < n; ++j) h[j] = out[j];
            off += m * n + n;
        }
        const T* log_std = pp + off;
        const int id = (int)carry[0];
        const int seed = (int)pp[off + A];
#pragma unroll
        for (int j = 0; j < A; ++j) {
            T v = h[j];
            if (!args.deterministic) v = v + dexp(log_std[j]) * hash_normal<T>(id, t, j, seed);
            a[j] = clampv(v, T(-1), T(1));
        }
    }
};
