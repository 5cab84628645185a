// closed_loop.cuh's kernel over classic_envs.cuh::VanDerPolEnv
#include "../closed_loop.cuh"

int closed_loop_van_der_pol(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<VanDerPolEnv>(args, dtype, stream);
}
