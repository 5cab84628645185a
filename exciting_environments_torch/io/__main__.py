"""Shard inspection CLI.

``python -m exciting_environments_torch.io <shard.extpu> [...]`` prints each
shard's record names with per-leaf shapes/dtypes and total payload size —
footer-only, so inspecting a multi-gigabyte shard is instant.
"""

from __future__ import annotations

import sys

from exciting_environments_torch.io.loader import ShardIndex, pretty_leaf_key


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0
    for path in argv:
        with ShardIndex(path) as idx:
            total = 0
            print(f"{path}: {len(idx)} records")
            for name, arrays in idx:
                parts = []
                for key, arr in arrays.items():
                    parts.append(f"{pretty_leaf_key(key)}: {arr.dtype}{list(arr.shape)}")
                    total += arr.nbytes
                print(f"  {name}  " + ", ".join(parts))
            print(f"  payload: {total / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
