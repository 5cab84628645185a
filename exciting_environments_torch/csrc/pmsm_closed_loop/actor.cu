// pmsm_closed_loop.cuh's kernel with the PPO actor (utils/rl_fused.py::ActorPolicy)
#include "../pmsm_closed_loop.cuh"

template <typename T, class Law>
static int launch_actor_law(const PmsmClArgs& args, cudaStream_t stream) {
    return args.saturated ? launch_stages<T, true, ActorAdapter<Law>>(args, stream)
                          : launch_stages<T, false, ActorAdapter<Law>>(args, stream);
}

template <typename T>
static int launch_actor(const PmsmClArgs& args, cudaStream_t stream) {
    if (args.n_layers < 1 || args.n_layers > MAX_LAYERS || args.widths[args.n_layers] != 2)
        return (int)cudaErrorInvalidValue;
    for (int l = 0; l <= args.n_layers; ++l)
        if (args.widths[l] < 1 || args.widths[l] > MAX_WIDTH) return (int)cudaErrorInvalidValue;
    if (args.n_layers == 3 && args.widths[1] == 16 && args.widths[2] == 16)
        return launch_actor_law<T, ActorReg<16, 16>>(args, stream);
    return launch_actor_law<T, ActorLaw>(args, stream);
}

int pmsm_closed_loop_actor(const PmsmClArgs& args, int dtype, cudaStream_t stream) {
    return dtype == 0 ? launch_actor<float>(args, stream) : launch_actor<double>(args, stream);
}
