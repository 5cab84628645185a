// PyTorch eager arithmetic rules that a kernel mirrors to agree bit for bit
// with its plain PyTorch version on the card.  Shared by stepper.cu and
// pmsm_stepper.cu.
//
// Build with --fmad=false, so that a * b + c is not contracted into an FMA
// (PyTorch's elementwise kernels round the product and the sum apart).
#pragma once

#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// Python-number folding.  An expression over scalar parameters is computed in
// Python (double precision) and rounded to the working type only when it
// meets a tensor; once a per-batch leaf takes part, the rest is computed in
// the working type.  Weak carries a value in either state.
// ---------------------------------------------------------------------------

template <typename T>
struct Weak {
    bool py;
    double d;
    T v;
};

template <typename T>
__device__ __forceinline__ T value(const Weak<T>& w) { return w.py ? (T)w.d : w.v; }

// A scalar (ptr null) or element b of a per-batch (B,) leaf.
template <typename T>
__device__ __forceinline__ Weak<T> weak_load(const void* ptr, double scalar, long long b) {
    Weak<T> w;
    w.py = ptr == nullptr;
    w.d = scalar;
    w.v = w.py ? T(0) : static_cast<const T*>(ptr)[b];
    return w;
}

template <typename T>
__device__ __forceinline__ Weak<T> weak_const(double c) {
    Weak<T> w;
    w.py = true;
    w.d = c;
    w.v = T(0);
    return w;
}

template <typename T>
__device__ __forceinline__ Weak<T> wmul(const Weak<T>& x, const Weak<T>& y) {
    Weak<T> r;
    r.py = x.py && y.py;
    r.d = r.py ? x.d * y.d : 0.0;
    r.v = r.py ? T(0) : value(x) * value(y);
    return r;
}

template <typename T>
__device__ __forceinline__ Weak<T> wadd(const Weak<T>& x, const Weak<T>& y) {
    Weak<T> r;
    r.py = x.py && y.py;
    r.d = r.py ? x.d + y.d : 0.0;
    r.v = r.py ? T(0) : value(x) + value(y);
    return r;
}

template <typename T>
__device__ __forceinline__ Weak<T> wsub(const Weak<T>& x, const Weak<T>& y) {
    Weak<T> r;
    r.py = x.py && y.py;
    r.d = r.py ? x.d - y.d : 0.0;
    r.v = r.py ? T(0) : value(x) - value(y);
    return r;
}

// Division by a parameter expression.  PyTorch's CUDA eager division by a
// host scalar (a Python number) multiplies by the scalar's reciprocal, taken
// in double precision and rounded to the working type; by a tensor it
// divides (correctly rounded).  On the CPU both divide.  (Measured on an H100
// with PyTorch 2.11; tests/test_torch_gpu.py pins the rule.)
template <typename T>
struct Divisor {
    bool recip;
    T v;  // the reciprocal for a host scalar, the divisor otherwise
};

template <typename T>
__device__ __forceinline__ Divisor<T> divisor(const Weak<T>& w) {
    Divisor<T> d;
    d.recip = w.py;
    d.v = w.py ? (T)(1.0 / w.d) : w.v;
    return d;
}

template <typename T>
__device__ __forceinline__ T operator/(T x, const Divisor<T>& d) {
    return d.recip ? x * d.v : x / d.v;
}

// y + tau * sum_j coeffs[j] * ks[j][leaf], as the solvers' _weighted_increment
// computes it: zero coefficients skipped, unit coefficients not multiplied,
// left-to-right sum; no stage at all leaves y.
template <typename T, int NS, int N>
__device__ __forceinline__ T lincomb(T y, const T (&ks)[NS][N], int leaf, const double* coeffs, int n, T tau) {
    bool any = false;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        if (j < n) {
            const double c = coeffs[j];
            if (c != 0.0) {
                const T term = (c == 1.0) ? ks[j][leaf] : (T)c * ks[j][leaf];
                acc = any ? acc + term : term;
                any = true;
            }
        }
    }
    return any ? y + tau * acc : y;
}
