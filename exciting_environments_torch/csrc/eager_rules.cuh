// PyTorch eager arithmetic rules that a kernel mirrors to agree bit for bit
// with its plain PyTorch version on the card.  Shared by every kernel in
// csrc/.
//
// Build with --fmad=false, so that a * b + c is not contracted into an FMA
// (PyTorch's elementwise kernels round the product and the sum apart).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

// A Python number divided by a tensor.  Tensor.__rtruediv__ is
// self.reciprocal() * other, on the CPU and on CUDA alike: the correctly
// rounded reciprocal, then a multiply by the number rounded to the working
// type (two roundings, where JAX divides once).  tests/test_torch_gpu.py
// pins the rule on the card.
template <typename T>
__device__ __forceinline__ T rdiv(double x, T y) {
    return (T(1) / y) * (T)x;
}

template <typename T>
__device__ __forceinline__ Weak<T> wneg(const Weak<T>& x) {
    Weak<T> r = x;
    r.d = -x.d;
    r.v = -x.v;
    return r;
}

// x ** 2: a Python float's square, or a tensor's (PyTorch's pow by 2 is
// x * x)
template <typename T>
__device__ __forceinline__ Weak<T> wsq(const Weak<T>& x) { return wmul(x, x); }

// x / y under the eager rules: Python numbers divide in double; a tensor by
// a number multiplies by the reciprocal (Divisor), a number by a tensor is
// rdiv, a tensor by a tensor divides
template <typename T>
__device__ __forceinline__ Weak<T> wdiv(const Weak<T>& x, const Weak<T>& y) {
    Weak<T> r;
    r.py = x.py && y.py;
    r.d = r.py ? x.d / y.d : 0.0;
    r.v = r.py ? T(0) : (y.py ? x.v / divisor(y) : (x.py ? rdiv(x.d, y.v) : x.v / y.v));
    return r;
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

// Pin a loop-invariant value in a register.  Without it the compiler may
// recompute the value from the kernel's parameters in every iteration
// (reload a double, compare, convert): the empty asm makes it opaque.
__device__ __forceinline__ void keep(unsigned& x) { asm volatile("" : "+r"(x)); }
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void keep(double& x) { asm volatile("" : "+d"(x)); }

// The tableau in the working type with its zero and unit masks (bit j of a
// row: coefficient j is non-zero / is exactly one), hoisted out of the loop.
template <typename T, int NS>
struct Tableau {
    T a[NS][NS], b[NS];
    unsigned a_nz[NS], a_one[NS], b_nz, b_one;
};

template <typename T, int NS, int M>
__device__ __forceinline__ Tableau<T, NS> tableau(const double (&a)[M][M], const double (&b)[M]) {
    Tableau<T, NS> tb;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        tb.a_nz[s] = tb.a_one[s] = 0u;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const double c = j < s ? a[s][j] : 0.0;
            tb.a[s][j] = (T)c;
            tb.a_nz[s] |= (unsigned)(c != 0.0) << j;
            tb.a_one[s] |= (unsigned)(c == 1.0) << j;
        }
    }
    tb.b_nz = tb.b_one = 0u;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        tb.b[j] = (T)b[j];
        tb.b_nz |= (unsigned)(b[j] != 0.0) << j;
        tb.b_one |= (unsigned)(b[j] == 1.0) << j;
    }
    // in registers for the whole loop: the non-zero, non-unit weights and
    // the masks
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        keep(tb.a_nz[s]);
        keep(tb.a_one[s]);
#pragma unroll
        for (int j = 0; j < s; ++j)
            if (a[s][j] != 0.0 && a[s][j] != 1.0) keep(tb.a[s][j]);
    }
    keep(tb.b_nz);
    keep(tb.b_one);
#pragma unroll
    for (int j = 0; j < NS; ++j)
        if (b[j] != 0.0 && b[j] != 1.0) keep(tb.b[j]);
    return tb;
}

// lincomb over the hoisted weights and masks: y + tau *
// sum_j w[j] * ks[j][leaf], zero weights skipped, unit weights not
// multiplied, left to right; no stage at all leaves y.
template <typename T, int NS, int N>
__device__ __forceinline__ T lincomb_masked(T y, const T (&ks)[NS][N], int leaf, const T* w, unsigned nz,
                                            unsigned one, int n, T tau) {
    bool any = false;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        if (j < n && ((nz >> j) & 1u)) {
            const T term = ((one >> j) & 1u) ? ks[j][leaf] : w[j] * ks[j][leaf];
            acc = any ? acc + term : term;
            any = true;
        }
    }
    return any ? y + tau * acc : y;
}

// ---------------------------------------------------------------------------
// Elementwise functions as PyTorch's CUDA kernels compute them
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dfmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double dfmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// torch.remainder / jnp.remainder (floored): fmod, then add the divisor
// where the signs differ and the result is non-zero.  For m > 0 and x in
// (-m, 2m), the range of an angle wrapped after one step, the result is
// taken without fmod's loop, and is the same bit for bit: x itself on
// [0, m) (-0 included); x - m on [m, 2m), which is exact (Sterbenz) and is
// what fmod returns; on (-m, 0) fmod returns x and the floored adjustment
// adds m, as here.  Every other input, NaN and inf included, takes fmod.
template <typename T>
__device__ __forceinline__ T floored_mod(T x, T m) {
    if (m > T(0)) {
        if (x >= T(0) && x < m) return x;
        if (x >= m && x < m + m) return x - m;
        if (x < T(0) && x > -m) return x + m;
    }
    T r = dfmod(x, m);
    if (r != T(0) && ((r < T(0)) != (m < T(0)))) r = r + m;
    return r;
}

// ((y + pi) % (2 pi)) - pi, the solver step's angle wrap.  Constants are
// Python floats rounded to T.
template <typename T>
__device__ __forceinline__ T wrap_angle(T y) {
    const T pi = (T)3.141592653589793;
    const T two_pi = (T)6.283185307179586;
    return floored_mod(y + pi, two_pi) - pi;
}

// torch.clamp(x, lo, hi): a NaN stays NaN (fminf/fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// torch.clamp(x, min=lo) and torch.clamp(x, max=hi) as PyTorch's CUDA
// kernel computes them: a NaN stays NaN, else fmax / fmin (which decide the
// sign of a zero as PyTorch's kernel does)
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ double clamp_min(double x, double lo) { return isnan(x) ? x : fmax(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ double clamp_max(double x, double hi) { return isnan(x) ? x : fmin(x, hi); }
