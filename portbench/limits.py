"""The readings that a cell's limits are set from, on the card:

    python3 portbench/limits.py --workload <cell> --seeds 1-12 --control-seeds 1-3 --seconds 3

For each seed, in one process: the cell's set-up, warm-up and a window of
``--seconds`` at its own load, then the largest reading of each compared
number over the checked calls, for the program (the lower readings) and,
on the control seeds, for the control: the plain reference computed in
bfloat16 in the program's place (the upper readings).  Writes
``chiprun_out/limits_<cell>.json``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args()
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from portbench import harness
    from portbench.window import Window

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    from exciting_environments_torch.ops.kernels import stepper

    stepper.build_all(cell.kernels)
    control = set(seeds(args.control_seeds)) if args.control_seeds else set()
    out = {"cell": args.workload, "card": harness.card_line("cuda"), "program": {}, "control": {}}
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        driver = harness.load_module(harness.HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(
            cell, seed, "cuda")
        driver.warmup(harness.WARMUP_CALLS)
        window = Window(args.seconds, seed, harness.CHECKED_CALLS)
        window.open()
        driver.run_window(window)
        torch.cuda.synchronize()
        driver.release()
        readings = driver.compare(torch.float64)
        out["program"][seed] = {k: max(r[k] for r in readings) for k in readings[0]}
        line = f"seed {seed}: {window.calls} calls, program {out['program'][seed]}"
        if seed in control:
            readings = driver.compare(control=True)
            out["control"][seed] = {k: max(r[k] for r in readings) for k in readings[0]}
            line += f", control {out['control'][seed]}"
        print(f"{line} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del driver
        torch.cuda.empty_cache()
    for side in ("program", "control"):
        if out[side]:
            keys = next(iter(out[side].values()))
            pick = max if side == "program" else min
            out[f"{side}_{pick.__name__}"] = {k: pick(r[k] for r in out[side].values()) for k in keys}
    print(json.dumps({k: out[k] for k in out if k.endswith(("_max", "_min"))}))
    dest = CHECKOUT / "chiprun_out" / f"limits_{args.workload}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
