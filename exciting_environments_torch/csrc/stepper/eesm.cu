// stepper.cuh's kernel over classic_envs.cuh::EESMEnv
#include "../stepper.cuh"

int stepper_eesm(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<EESMEnv>(args, dtype, stream);
}
