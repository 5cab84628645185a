// Fast-math building blocks on the device, the counterparts of
// exciting_environments_torch/ops/fastmath.py: the polynomial sine, the
// floored-modulo angle wrap, and the select-free sign.  Shared by the
// classic environments' fast functors (classic_envs.cuh) and the fast-math
// kernels (pendulum_fast.cu, pmsm_fast.cu).
//
// Each function performs the PyTorch version's tensor operations one by one
// in the working precision, under the rules of eager_rules.cuh: build with
// --fmad=false (poly_sin's Horner chain is separate multiplies and adds), and
// the division by the Python number 2 pi is a multiply by its reciprocal,
// taken in double and rounded to the working type, as PyTorch's CUDA eager
// path computes it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "eager_rules.cuh"

__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return floor(x); }

// ops/fastmath.py::poly_sin: c15 x2 + c13, ..., then x * acc.  The odd
// coefficients c1..c15 are float32 values (SIN_ODD_COEFFS).
template <typename T>
__device__ __forceinline__ T poly_sin(T x) {
    constexpr double c[8] = {0x1.0p+0,        -0x1.555556p-3,  0x1.11111p-7,   -0x1.a019e4p-13,
                             0x1.71db9ep-19,  -0x1.ae2152p-26, 0x1.5d4fb2p-33, -0x1.726fcp-41};
    const T x2 = x * x;
    T acc = (T)c[7];
#pragma unroll
    for (int i = 6; i >= 0; --i) acc = acc * x2 + (T)c[i];
    return x * acc;
}

// ops/fastmath.py::wrap_angle_fast: x - 2 pi floor((x + pi) / (2 pi))
template <typename T>
__device__ __forceinline__ T wrap_angle_fast(T x) {
    const T pi = (T)3.141592653589793;
    const T two_pi = (T)6.283185307179586;
    const T inv_two_pi = (T)(1.0 / 6.283185307179586);
    return x - two_pi * dfloor((x + pi) * inv_two_pi);
}

// ops/fastmath.py::sin_wrapped
template <typename T>
__device__ __forceinline__ T sin_wrapped(T x) {
    return poly_sin(wrap_angle_fast(x));
}

// ops/fastmath.py::poly_cos: poly_sin(wrap(x + pi / 2))
template <typename T>
__device__ __forceinline__ T poly_cos(T x) {
    return poly_sin(wrap_angle_fast(x + (T)1.5707963267948966));
}

// ops/fastmath.py::fast_sign: clamp(x * 1e30, -1, 1), NaN stays NaN
template <typename T>
__device__ __forceinline__ T fast_sign(T x) {
    return clampv(x * (T)1e30, T(-1), T(1));
}
