"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` from the run's
start to the window's close, in GiB."""


def read(run) -> float:
    return run.peak_bytes / 2**30
