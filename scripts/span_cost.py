"""What one of the program's spans costs on this host:

    python3 scripts/span_cost.py [--n 200000]

Times ``utils/profiling.py::annotate`` entered and left ``--n`` times in a
row, with no profiler recording (the shared null context) and while
``torch.profiler`` records (a ``record_function``, with the card's activity
where there is a card), and a bare ``torch.profiler.record_function`` with
no profiler, the helper's cost before it checked.  Prints microseconds per
span, the best of five repeats, with torch's version and the card's name
and power limit.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from exciting_environments_torch.utils.profiling import annotate  # noqa: E402


def per_span_us(make, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=200_000)
    n = parser.parse_args(argv).n
    card = "no card"
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, {card}")
    print(f"annotate, no profiler: {per_span_us(lambda: annotate('ee.fleet.chunk'), n):.3f} us per span")
    bare = per_span_us(lambda: torch.profiler.record_function("ee.fleet.chunk"), n)
    print(f"record_function, no profiler: {bare:.3f} us per span")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities):
        on = per_span_us(lambda: annotate("ee.fleet.chunk"), n // 20)
    print(f"annotate, profiler recording: {on:.3f} us per span")


if __name__ == "__main__":
    main()
