// The plain C entry point of the stepper library, loaded with ctypes: the
// kernel and its launchers are in stepper.cuh, and each
// environment's instantiations in a translation unit of their own,
// stepper/<environment>.cu.

#include "stepper.cuh"

extern "C" int stepper_args_size() { return (int)sizeof(StepperArgs); }

// dtype: 0 float32, 1 float64.  Returns cudaGetLastError() after the launch.
extern "C" int stepper_launch(const StepperArgs* args, int dtype, void* stream) {
    if (args->batch <= 0) return 0;
    if (args->hold <= 0 || args->n_steps % args->hold) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (args->env_id) {
        case 0: return stepper_pendulum(*args, dtype, s);
        case 1: return stepper_mass_spring_damper(*args, dtype, s);
        case 2: return stepper_cart_pole(*args, dtype, s);
        case 3: return stepper_van_der_pol(*args, dtype, s);
        case 4: return stepper_fluid_tank(*args, dtype, s);
        case 5: return stepper_acrobot(*args, dtype, s);
        case 6: return stepper_induction_machine(*args, dtype, s);
        case 7: return stepper_eesm(*args, dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
