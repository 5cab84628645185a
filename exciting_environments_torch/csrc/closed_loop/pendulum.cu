// closed_loop.cuh's kernel over classic_envs.cuh::PendulumEnv<ExactMath>, <FastMath>
#include "../closed_loop.cuh"

int closed_loop_pendulum(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<PendulumEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<PendulumEnv<ExactMath>>(args, dtype, stream);
}
