"""Compare the SASS that two checkouts compile from kernel translation units.

    python3 scripts/compare_sass.py [--diff N] CHECKOUT_A CHECKOUT_B UNIT [UNIT ...]

Each CHECKOUT is a directory holding an ``exciting_environments_torch``
package (a ``git archive`` of a commit, or the working tree); each UNIT a
source path under its ``csrc/`` (``closed_loop/pendulum.cu``).  Every unit
of both checkouts is compiled to a cubin with the build's flags
(``ops/kernels/stepper.py::NVCC_FLAGS`` of this tree, without the resource
report), all ``nvcc`` processes started together, then disassembled with
``cuobjdump -sass``.  Per unit it prints the kernels found in both, how many
of them differ (instructions compared with their addresses stripped) and the
kernels found in one checkout only (with ``--diff N``, the first N lines
of each differing kernel's unified diff); the last line is one JSON object
with the counts.  Exits 1 when a kernel found in both differs.  Needs the CUDA
toolkit, not a card.
"""

from __future__ import annotations

import difflib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_functions(cubin: Path) -> dict:
    """``{kernel name: [instruction, ...]}`` of a cubin, addresses stripped."""
    text = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), [])
        elif current is not None and "/*" in line:
            current.append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).strip())
    return funcs


def main(argv) -> int:
    show = 0
    if argv[:1] == ["--diff"]:
        show, argv = int(argv[1]), argv[2:]
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from exciting_environments_torch.ops.kernels.stepper import NVCC_FLAGS, _nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    checkouts, units = [Path(a).resolve() for a in argv[:2]], argv[2:]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for side, checkout in zip("AB", checkouts):
            for unit in units:
                src = checkout / "exciting_environments_torch" / "csrc" / unit
                out = Path(tmp) / f"{side}.{unit.replace('/', '.')}.cubin"
                procs[(side, unit)] = (out, subprocess.Popen([_nvcc(), *flags, "-cubin", "-o", str(out), str(src)],
                                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                             text=True))
        for (side, unit), (out, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"nvcc failed on {side} {unit}:\n{log}", file=sys.stderr)
                return 2
        differ = 0
        for unit in units:
            a = sass_functions(procs[("A", unit)][0])
            b = sass_functions(procs[("B", unit)][0])
            both = sorted(set(a) & set(b))
            changed = [n for n in both if a[n] != b[n]]
            differ += len(changed)
            results[unit] = {"both": len(both), "differing": len(changed), "only_a": len(set(a) - set(b)),
                             "only_b": len(set(b) - set(a))}
            print(f"{unit}: {len(both)} kernels in both, {len(changed)} differing; {len(set(a) - set(b))} only in "
                  f"A, {len(set(b) - set(a))} only in B", flush=True)
            for name in changed:
                print(f"  differs: {name}: {len(a[name])} -> {len(b[name])} instructions")
                for line in list(difflib.unified_diff(a[name], b[name], lineterm="", n=1))[2:2 + show]:
                    print(f"    {line}")
    print(json.dumps({"sass": results}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
