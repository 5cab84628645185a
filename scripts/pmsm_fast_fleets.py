"""Time the fast PMSM kernel (``csrc/pmsm_fast.cu``) of several checkouts on
two fleets, in the order given, on one CUDA card.

    python3 scripts/pmsm_fast_fleets.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding an ``exciting_environments_torch``
package (a ``git archive`` of a commit, or a variant of one).  Name a
checkout more than once to alternate them (A B B A): each name is run in a
fresh process, in turn, after every distinct checkout's kernel library was
built, all builds started together.

Each run makes the same data from the seed: saturated BRUSA, B = 65,536,
T = 256, float32, actions in +-0.3 (``chip_smoke.py`` phase 14's main case),
and ``chip_smoke.py``'s holding fleet, whose drives stay inside their
current bands and so gather all over the table (the random fleet's drives
run away to the table's edge cells).  On each fleet it times, as medians of
5 CUDA-event timings after a warm-up, over one call and per call over ten
calls back to back:

* the kernel alone (its wrapper ``kernel_pmsm_fast_rollout``) on a
  time-major and on a batch-major slab; a checkout whose kernel reads only
  time-major slabs and takes its start from ``fast_start`` (before the start
  moved into the launch) gets its time-major arguments and no batch-major
  time;
* the entry point ``PMSM.fast_rollout`` on either layout.

It also prints a digest of the final states of ``PMSM.fast_rollout``: every
checkout of one semantics gives the same bits.  The last lines are the
card's name and power limit and one JSON object with every run.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, T, SEED = 65536, 256, 7
CHAIN = 10
FIELDS = ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer")


def build_all(checkouts):
    """Build each checkout's pmsm_fast library, one process each, together."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from exciting_environments_torch.ops.kernels.stepper import build; print(build('pmsm_fast'))")
    procs = {c: subprocess.Popen([sys.executable, "-c", code], cwd=c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for c in dict.fromkeys(checkouts)}
    for c, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"building pmsm_fast in {c} failed:\n{out[-3000:]}")


def run_one(checkout: str) -> dict:
    """The timings of one checkout (this process imports its package)."""
    import torch

    sys.path.insert(0, str(Path(checkout).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import exciting_environments_torch as ex
    from exciting_environments_torch.ops import pmsm_fast as PF
    from exciting_environments_torch.ops.kernels import pmsm_fast_kernel as PMK

    if not Path(ex.__file__).resolve().is_relative_to(Path(checkout).resolve()):
        raise RuntimeError(f"imported {ex.__file__}, not the package of {checkout}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, tau=1e-4, device="cuda")
    _, state = env.vmap_reset(rng=gen)
    u = torch.rand((B, T, 2), generator=gen, device="cuda", dtype=torch.float64)
    fleets = {"random": (state, ((u * 2 - 1) * 0.3).float())}
    del u
    fleets["holding"] = cs.holding_fleet(ex, env, gen, T)

    in_place = hasattr(PMK, "pack_args")

    def kernel_call(st, acts_bm, batch_major):
        if in_place:
            acts = acts_bm if batch_major else acts_bm.transpose(0, 1).contiguous()
            consts, _, lv = PF.fast_inputs(env, st, acts, not batch_major)
            return lambda: PMK.kernel_pmsm_fast_rollout(env, acts, lv, consts, batch_major)
        if batch_major:
            return None
        consts, acts_tm, lv = PF.fast_inputs(env, st, acts_bm.transpose(0, 1).contiguous(), True)
        cA, sA, c_delta, s_delta = PF.fast_start(lv["epsilon"], lv["omega_el"], consts)
        args = (env, acts_tm, lv["i_d"], lv["i_q"], cA, sA, lv["u_d_buffer"], lv["u_q_buffer"], lv["omega_el"],
                c_delta, s_delta, consts)
        return lambda: PMK.kernel_pmsm_fast_rollout(*args)

    times, digest = {}, hashlib.sha256()
    for fleet, (st, acts_bm) in fleets.items():
        acts_tm = acts_bm.transpose(0, 1).contiguous()
        for layout, batch_major in (("time-major", False), ("batch-major", True)):
            call = kernel_call(st, acts_bm, batch_major)
            for chain in (1, CHAIN):
                key = f"{fleet} kernel {layout} {'one call' if chain == 1 else f'{chain} back to back'}"
                times[key] = cs.time_ms(call, chain=chain) if call else None
            acts = acts_bm if batch_major else acts_tm
            entry = lambda: env.fast_rollout(st, acts, time_major=not batch_major)
            for chain in (1, CHAIN):
                key = f"{fleet} fast_rollout {layout} {'one call' if chain == 1 else f'{chain} back to back'}"
                times[key] = cs.time_ms(entry, chain=chain)
            last = entry().physical_state
            for name in FIELDS:
                digest.update(getattr(last, name).contiguous().cpu().numpy().tobytes())
        del acts_tm
    return {"checkout": checkout, "in_place": in_place, "digest": digest.hexdigest()[:16], "ms": times}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("pmsm_fast_fleets: no CUDA device is available", file=sys.stderr)
        return 2
    checkouts = sys.argv[1:]
    if not checkouts:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    build_all(checkouts)
    print(f"[build] {len(set(checkouts))} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for i, c in enumerate(checkouts):
        out = subprocess.run([sys.executable, __file__, "--one", c], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"[run {i + 1}] {c} digest {run['digest']}", flush=True)
        for key, ms in run["ms"].items():
            print(f"    {key}: {ms!r} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
