// closed_loop.cuh's kernel over classic_envs.cuh::EESMEnv, with its drive-control
// tiles (foc_laws.cuh::EesmCurrentTile)
#include "../closed_loop.cuh"

int closed_loop_eesm(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<EESMEnv, EesmCurrentTile>(args, dtype, stream);
}
