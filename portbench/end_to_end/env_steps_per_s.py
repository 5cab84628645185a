"""``env_steps_per_s``: every environment step of the calls the window
completed, over the window's seconds (its start to its last completion)."""


def read(run) -> float:
    return run.calls * run.steps_per_call / run.window_s
