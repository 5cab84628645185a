// stepper.cuh's kernel over classic_envs.cuh::VanDerPolEnv
#include "../stepper.cuh"

int stepper_van_der_pol(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<VanDerPolEnv>(args, dtype, stream);
}
