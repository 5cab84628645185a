// stepper.cuh's kernel over classic_envs.cuh::AcrobotEnv<ExactMath>, <FastMath>
#include "../stepper.cuh"

int stepper_acrobot(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<AcrobotEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<AcrobotEnv<ExactMath>>(args, dtype, stream);
}
