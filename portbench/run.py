"""Run one cell of the benchmark on this machine's card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's lines, then, as the last
line of standard output, one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` in a traced run) and,
last, ``checks``: each number compared beside its limit, which also close
standard error.  Exits with another code than 0, and prints no result,
without a CUDA card, when the program cannot be imported, when the
process holds ``jax``, ``jaxlib``, ``flax`` or ``exciting_environments_tpu``
once the window has closed, or when a traced run finds nothing to read for
one of its cell's per-layer metrics.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
#: the program's kernel caches, at fixed paths inside the checkout (the
#: nvcc build directory is the package's own ``_build``)
CACHES = {"TRITON_CACHE_DIR": CHECKOUT / ".portbench_cache" / "triton",
          "TORCH_EXTENSIONS_DIR": CHECKOUT / ".portbench_cache" / "torch_extensions"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    sys.path.insert(0, str(CHECKOUT))

    import torch

    chips = json.loads((CHECKOUT / "portbench" / "workloads" / f"{args.workload}.json").read_text())["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] the cell needs {chips} CUDA card(s): the benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 2

    from portbench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                                  log=lambda line: print(line, flush=True))
    except harness.MissingReading as missing:
        print(f"[portbench] {missing}; no result", file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if result is None or found:
        print(f"[portbench] forbidden modules loaded: {found}; no result", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"[portbench] check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
