// closed_loop.cuh's kernel over classic_envs.cuh::FluidTankEnv
#include "../closed_loop.cuh"

int closed_loop_fluid_tank(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<FluidTankEnv>(args, dtype, stream);
}
