// stepper.cuh's kernel over classic_envs.cuh::InductionMachineEnv
#include "../stepper.cuh"

int stepper_induction_machine(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<InductionMachineEnv>(args, dtype, stream);
}
