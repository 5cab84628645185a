// closed_loop.cuh's kernel over classic_envs.cuh::MassSpringDamperEnv
#include "../closed_loop.cuh"

int closed_loop_mass_spring_damper(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<MassSpringDamperEnv>(args, dtype, stream);
}
