// stepper.cuh's kernel over classic_envs.cuh::CartPoleEnv<ExactMath>, <FastMath>
#include "../stepper.cuh"

int stepper_cart_pole(const StepperArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<CartPoleEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<CartPoleEnv<ExactMath>>(args, dtype, stream);
}
