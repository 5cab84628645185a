// stepper.cuh's kernel over classic_envs.cuh::FluidTankEnv
#include "../stepper.cuh"

int stepper_fluid_tank(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<FluidTankEnv>(args, dtype, stream);
}
