// closed_loop.cuh's kernel over classic_envs.cuh::InductionMachineEnv, with its drive-control
// tiles (foc_laws.cuh::FocTile, SensorlessFocTile and their per-drive FocDriveTile,
// SensorlessFocDriveTile)
#include "../closed_loop.cuh"

int closed_loop_induction_machine(const ClosedLoopArgs& args, int dtype, cudaStream_t stream) {
    return launch_env_dtype<InductionMachineEnv, FocTile, SensorlessFocTile, FocDriveTile, SensorlessFocDriveTile>(
        args, dtype, stream);
}
