// closed_loop.cuh's kernel over classic_envs.cuh::AcrobotEnv<ExactMath>, <FastMath>
#include "../closed_loop.cuh"

int closed_loop_acrobot(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return args.fast ? launch_env_dtype<AcrobotEnv<FastMath>>(args, dtype, stream)
                     : launch_env_dtype<AcrobotEnv<ExactMath>>(args, dtype, stream);
}
