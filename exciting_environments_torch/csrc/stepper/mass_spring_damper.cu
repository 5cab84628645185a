// stepper.cuh's kernel over classic_envs.cuh::MassSpringDamperEnv
#include "../stepper.cuh"

int stepper_mass_spring_damper(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<MassSpringDamperEnv>(args, dtype, stream);
}
