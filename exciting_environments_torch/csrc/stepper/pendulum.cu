// stepper.cuh's kernel over classic_envs.cuh::PendulumEnv<ExactMath>, <FastMath>
#include "../stepper.cuh"

int stepper_pendulum(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<PendulumEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<PendulumEnv<ExactMath>>(args, dtype, stream);
}
