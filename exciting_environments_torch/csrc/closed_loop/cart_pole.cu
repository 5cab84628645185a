// closed_loop.cuh's kernel over classic_envs.cuh::CartPoleEnv<ExactMath>, <FastMath>
#include "../closed_loop.cuh"

int closed_loop_cart_pole(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<CartPoleEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<CartPoleEnv<ExactMath>>(args, dtype, stream);
}
