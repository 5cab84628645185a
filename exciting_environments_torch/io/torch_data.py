"""PyTorch datasets over collected shards (counterpart of
``exciting_environments_tpu/io/torch_data.py``).

:class:`TorchShardDataset` exposes one or more ``.extpu`` shards (written by
either package) as a standard map-style ``torch.utils.data.Dataset``:
footer-only indexing, so opening a multi-gigabyte shard costs one mmap, and
each ``__getitem__`` materializes exactly one record as host tensors.  The
dataset is picklable (only the paths and the transform are carried; shard
maps reopen in the receiving process), so ``DataLoader(num_workers>0)``
works under every multiprocessing start method.

Example::

    from torch.utils.data import DataLoader
    from exciting_environments_torch.io import TorchShardDataset

    ds = TorchShardDataset(["fleet_0.extpu", "fleet_1.extpu"])
    for batch in DataLoader(ds, batch_size=32, shuffle=True):
        batch["final_obs"]  # torch.Tensor, stacked over records
"""

from __future__ import annotations

import numpy as np
import torch

from exciting_environments_torch.io.loader import ShardIndex, pretty_leaf_key as _pretty_key


class TorchShardDataset(torch.utils.data.Dataset):
    """Map-style torch dataset over ``.extpu`` shards.

    Each item is ``{leaf_path: torch.Tensor}`` (host tensors) for one written
    record (one ``ShardWriter.append`` call, e.g. a fleet chunk).  Tensors
    are copies: the shard map is read-only, and copies are required anyway
    once a ``DataLoader`` ships items across worker processes.

    Args:
        paths: one shard path or a list (records are concatenated in order).
        transform: optional ``transform(name, tensors) -> item`` applied per
            record (e.g. select/reshape leaves, build (input, target) pairs).
    """

    def __init__(self, paths, transform=None):
        if isinstance(paths, (str, bytes)) or not hasattr(paths, "__iter__"):
            paths = [paths]
        self._paths = list(paths)
        self.transform = transform
        self._open()

    def _open(self):
        self._indices = [ShardIndex(p) for p in self._paths]
        self._offsets = []  # (shard_idx, local_idx) per global record
        for si, idx in enumerate(self._indices):
            self._offsets.extend((si, li) for li in range(len(idx)))

    # mmap handles are unpicklable; carry only the construction args and
    # reopen in the receiving process (DataLoader workers under
    # spawn/forkserver pickle the dataset)
    def __getstate__(self):
        return {"_paths": self._paths, "transform": self.transform}

    def __setstate__(self, state):
        self._paths = state["_paths"]
        self.transform = state["transform"]
        self._open()

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, i):
        si, li = self._offsets[i]
        name, arrays = self._indices[si].entry(li)
        tensors = {
            _pretty_key(k): torch.from_numpy(np.array(v))  # copy: the map is read-only
            for k, v in arrays.items()
        }
        if self.transform is not None:
            return self.transform(name, tensors)
        return tensors

    @property
    def names(self):
        """Record names in global order (``chunk_000001``, ...)."""
        per_shard = [idx.names for idx in self._indices]
        return [per_shard[si][li] for si, li in self._offsets]

    def close(self):
        for idx in self._indices:
            idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
