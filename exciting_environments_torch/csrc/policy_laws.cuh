// Policy functors shared by the closed-loop kernels (closed_loop.cu for the
// classic environments, pmsm_closed_loop.cu for the PMSM drive).
//
// A functor's act<T, A, MAX_N>(args, pp, obs, n_obs, t, carry, a) reads the
// flat parameters pp (in shared memory), the n_obs observation columns obs
// (at most MAX_N, the size of the caller's register array), updates the
// policy carry in place and writes the A normalized actions.  Args is the
// calling kernel's argument struct; a functor reads only the option fields
// it names (has_integral, has_clip, clip).
#pragma once

#include <cuda_runtime.h>

#include "eager_rules.cuh"

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
