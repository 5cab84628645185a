"""``setup_s``: from the start of ``run.py`` to the window's first call:
imports, the kernel libraries' build or load, the inputs, the program's
set-up and the warm-up."""


def read(run) -> float:
    return run.setup_s
