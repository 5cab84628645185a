// The PMSM drive's state-independent angle recurrence on the card: for each
// drive, the pre-step angles eps_0 .. eps_{T-1} and the final eps_T of
// eps_{t+1} = wrap(eps_t + tau * rate), one thread a drive.  The eager
// version (ops/kernels/pmsm_stepper.py::_eps_trajectory) takes five launches a
// step; the closed loop's trajectory rebuild (pmsm_closed_loop.py::
// pmsm_fused_closed_loop with obs_stride) takes this one launch in their
// place.  The arithmetic is the eager version's, operation for operation in
// the working type: tau is the Python number cast to T as a CUDA multiply by
// a scalar casts it, and the wrap is eager_rules.cuh's floored_mod, torch's
// remainder; so every angle equals the eager one bit for bit (and the closed-
// loop kernel's own, which advances the angle the same way).  Build with
// --fmad=false.

#include <cuda_runtime.h>

#include "eager_rules.cuh"

// Mirrored field for field by PmsmAnglesArgs in ops/kernels/pmsm_angles.py.
struct PmsmAnglesArgs {
    double tau;
    const void* eps0;  // (B,)
    const void* rate;  // (B,) the angle's rate, ops/kernels/pmsm_stepper.py::_eps_rate
    void* seq;         // (T, B) the pre-step angles
    void* final;       // (B,) the angle after the last step
    long long batch;
    int n_steps;
};

template <typename T>
__global__ void pmsm_angles_kernel(const __grid_constant__ PmsmAnglesArgs args) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= args.batch) return;
    T tau = (T)args.tau;
    keep(tau);
    const T inc = tau * static_cast<const T*>(args.rate)[b];
    T eps = static_cast<const T*>(args.eps0)[b];
    T* seq = static_cast<T*>(args.seq) + b;
    for (int t = 0; t < args.n_steps; ++t) {
        seq[(long long)t * args.batch] = eps;
        eps = wrap_angle(eps + inc);
    }
    static_cast<T*>(args.final)[b] = eps;
}

extern "C" int pmsm_angles_args_size() { return (int)sizeof(PmsmAnglesArgs); }

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
extern "C" int pmsm_angles_launch(const PmsmAnglesArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    if (args->n_steps < 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((args->batch + 127) / 128);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        pmsm_angles_kernel<float><<<blocks, 128, 0, s>>>(*args);
    else
        pmsm_angles_kernel<double><<<blocks, 128, 0, s>>>(*args);
    return (int)cudaGetLastError();
}
