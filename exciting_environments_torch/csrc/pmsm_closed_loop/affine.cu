// pmsm_closed_loop.cuh's kernel with ops/policies.py::AffinePolicy (the P and
// PI laws), in two instantiations: the law over every observation column,
// and the law over the columns of a current-tracking law, its gains in
// registers
#include "../pmsm_closed_loop.cuh"

// AffinePolicy over every column: policy_laws.cuh's AffineLaw, its gains
// read from shared memory each step.  (Held in registers, the dense law's
// up to 50 gains take the kernel from 86 to 148 registers, below the four
// blocks an SM holds at B = 65,536, and 1.2x slower.)
struct AffineAdapter {
    static constexpr bool SCHEDULED = false;  // reads no scheduled gather
    static constexpr bool PREPARES = false;
    static constexpr int COLUMNS = COLS_ALL;
    template <typename T>
    __device__ __forceinline__ static void act(const PmsmClArgs& args, const T* pp, const T* obs, int n_obs,
                                               const T*, int t, T* c, T* a) {
        AffineLaw::template act<T, 2, MAX_OBS>(args, pp, obs, n_obs, t, c, a);
    }
};

// AffinePolicy over i_d, i_q, omega and the references (COLS_CURRENTS), for
// gains that are zero on every other column; pp = K (2 x n_obs), b (2), [Ki
// (2 x n_obs)], the columns it reads loaded into registers once per thread
// (closed_loop.cuh's AffineReg at a run-time width).  Bias first, then the
// columns it reads in ascending order; then the carry, then the add; then
// the clamp: AffinePolicy.forward's order with the exact-zero terms left out.
struct AffineCurrentsReg {
    static constexpr bool SCHEDULED = false;
    static constexpr bool PREPARES = true;
    static constexpr int COLUMNS = COLS_CURRENTS;
    template <typename T>
    struct Prepared {
        T K[2][MAX_OBS], b[2], Ki[2][MAX_OBS];
        T lo, hi;
        int n_obs;
        unsigned integral, clip;
    };
    // column i is one of the law's: read, and present at the run-time width
    __device__ __forceinline__ static bool reads(int i, int n_obs) {
        return column_read(COLUMNS, i) && (i < N_BASE_OBS || i < n_obs);
    }
    template <typename T>
    __device__ __forceinline__ static Prepared<T> prepare(const PmsmClArgs& args, const T* pp, const T*) {
        Prepared<T> p;
        const int n_obs = N_BASE_OBS + args.n_refs;
        p.n_obs = n_obs;
        p.integral = args.has_integral != 0;
        p.clip = args.has_clip != 0;
        p.lo = (T)(-args.clip);
        p.hi = (T)args.clip;
        const T* Ki = pp + 2 * n_obs + 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            p.b[j] = pp[2 * n_obs + j];
            keep(p.b[j]);
#pragma unroll
            for (int i = 0; i < MAX_OBS; ++i) {
                if (!column_read(COLUMNS, i)) continue;
                p.K[j][i] = reads(i, n_obs) ? pp[j * n_obs + i] : T(0);
                p.Ki[j][i] = reads(i, n_obs) && p.integral ? Ki[j * n_obs + i] : T(0);
                keep(p.K[j][i]);
                keep(p.Ki[j][i]);
            }
        }
        keep(p.lo);
        keep(p.hi);
        keep(p.integral);
        keep(p.clip);
        return p;
    }
    template <typename T>
    __device__ __forceinline__ static void act(const Prepared<T>& p, const PmsmClArgs&, const T*,
                                               const T (&obs)[MAX_OBS], int, const T*, int, T* c, T (&a)[2]) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            T acc = p.b[j];
#pragma unroll
            for (int i = 0; i < MAX_OBS; ++i)
                if (reads(i, p.n_obs)) acc = acc + p.K[j][i] * obs[i];
            if (p.integral) {
                T ci = c[j];
#pragma unroll
                for (int i = 0; i < MAX_OBS; ++i)
                    if (reads(i, p.n_obs)) ci = ci + p.Ki[j][i] * obs[i];
                c[j] = ci;
                acc = acc + ci;
            }
            if (p.clip) acc = clampv(acc, p.lo, p.hi);
            a[j] = acc;
        }
    }
};

template <typename T, class Law>
static int launch_affine_law(const PmsmClArgs& args, cudaStream_t stream) {
    return args.saturated ? launch_stages<T, true, Law>(args, stream) : launch_stages<T, false, Law>(args, stream);
}

template <typename T>
static int launch_affine(const PmsmClArgs& args, cudaStream_t stream) {
    switch (args.affine_columns) {
        case COLS_ALL: return launch_affine_law<T, AffineAdapter>(args, stream);
        case COLS_CURRENTS: return launch_affine_law<T, AffineCurrentsReg>(args, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

int pmsm_closed_loop_affine(const PmsmClArgs& args, int dtype, cudaStream_t stream) {
    return dtype == 0 ? launch_affine<float>(args, stream) : launch_affine<double>(args, stream);
}
