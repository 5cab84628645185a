// The plain C entry point of the closed_loop library, loaded with ctypes: the
// kernel, its policies and launchers are in closed_loop.cuh, and each
// environment's instantiations in a translation unit of their own,
// closed_loop/<environment>.cu.

#include "closed_loop.cuh"

extern "C" int closed_loop_args_size() { return (int)sizeof(ClosedLoopArgs); }

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
extern "C" int closed_loop_launch(const ClosedLoopArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    if (args->n_pp > MAX_POLICY_PARAMS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (args->env_id) {
        case 0: return closed_loop_pendulum(*args, dtype, s);
        case 1: return closed_loop_mass_spring_damper(*args, dtype, s);
        case 2: return closed_loop_cart_pole(*args, dtype, s);
        case 3: return closed_loop_van_der_pol(*args, dtype, s);
        case 4: return closed_loop_fluid_tank(*args, dtype, s);
        case 5: return closed_loop_acrobot(*args, dtype, s);
        case 6: return closed_loop_induction_machine(*args, dtype, s);
        case 7: return closed_loop_eesm(*args, dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
