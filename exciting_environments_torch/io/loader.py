"""Reader-side data pipeline: shard -> host -> device prefetching
(counterpart of ``exciting_environments_tpu/io/loader.py``).

Two layers:

- :func:`read_shard_lazy` / :class:`ShardIndex`: parse only the footer
  (header JSON) of a shard and memory-map the payload, so opening a
  multi-gigabyte shard costs a few kilobytes of IO and arrays are zero-copy
  NumPy views until touched.
- :class:`DeviceLoader`: a prefetching iterator.  A background thread walks
  the shard entries, applies an optional host-side ``transform``, copies
  each leaf into pinned host memory and issues its host->device copy on a
  copy stream of its own, so the copies of entries ``i+1``/``i+2`` overlap
  the device work that consumes entry ``i``.

The JAX package's ``jax.device_put`` is asynchronous by itself.  A PyTorch
copy is asynchronous only from pinned (page-locked) memory: from pageable
memory ``non_blocking=True`` copies synchronously.  So the worker writes
each mapped view into a pinned buffer (never ``torch.from_numpy`` on the
read-only map), issues ``.to(device, non_blocking=True)`` on a dedicated
``torch.cuda.Stream``, records a ``torch.cuda.Event`` and keeps the pinned
buffers until that event has passed.  Before an entry is handed over, the
consumer's current stream waits on the event, and each tensor is
``record_stream``-ed on that stream, so the caching allocator does not
reuse its memory while the consumer's kernels still read it.
"""

from __future__ import annotations

import collections
import json
import mmap
import queue
import re
import struct
import threading

import numpy as np
import torch

from exciting_environments_torch.core.env import resolve_device
from exciting_environments_torch.io.dataset import MAGIC

#: leaf paths are JAX keystr strings; a flat-dict record's "['obs']" reads
#: better as plain "obs" (nested tree paths keep the full keystr)
_SIMPLE_KEY = re.compile(r"^\['([^'\[\]]+)'\]$")


def pretty_leaf_key(path: str) -> str:
    """Human-friendly leaf key: ``"['obs']"`` -> ``"obs"``; nested tree
    paths are returned unchanged."""
    m = _SIMPLE_KEY.match(path)
    return m.group(1) if m else path


class ShardIndex:
    """Footer-only view of one shard: entry names + zero-copy leaf arrays.

    The file is memory-mapped; ``entry(i)`` returns NumPy views into the
    map (no copies).  Keep the index alive while views are in use.
    """

    def __init__(self, path):
        self.path = str(path)
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        n = len(self._mm)
        tail = len(MAGIC) + 8
        if n < len(MAGIC) + tail or self._mm[: len(MAGIC)] != MAGIC or self._mm[n - len(MAGIC) :] != MAGIC:
            raise ValueError(f"{path!r} is not a (complete) EXTPU1 shard")
        (header_len,) = struct.unpack("<Q", self._mm[n - tail : n - len(MAGIC)])
        header_start = n - tail - header_len
        self._entries = json.loads(self._mm[header_start : header_start + header_len])["entries"]
        self._base = len(MAGIC)

    def __len__(self):
        return len(self._entries)

    @property
    def names(self):
        return [e["name"] for e in self._entries]

    def entry(self, i: int):
        """Return ``(name, {leaf_path: np.ndarray})`` for entry ``i`` as
        zero-copy views into the mapped file."""
        e = self._entries[i]
        arrays = {}
        for leaf in e["leaves"]:
            start = self._base + leaf["offset"]
            arrays[leaf["path"]] = np.frombuffer(
                self._mm, dtype=np.dtype(leaf["dtype"]), count=int(np.prod(leaf["shape"], dtype=np.int64)),
                offset=start,
            ).reshape(leaf["shape"])
        return e["name"], arrays

    def __iter__(self):
        for i in range(len(self)):
            yield self.entry(i)

    def close(self):
        # the mmap holds its own fd reference and outstanding views keep the
        # map alive; release our handles and let the last view unmap it
        self._f.close()
        try:
            self._mm.close()
        except BufferError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_shard_lazy(path):
    """Iterate ``(name, arrays)`` over a shard without loading it whole."""
    with ShardIndex(path) as idx:
        for name, arrays in idx:
            # materialize copies so the map can close
            yield name, {k: np.array(v) for k, v in arrays.items()}


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class DeviceLoader:
    """Prefetching shard -> device iterator.

    Iterates ``(name, {leaf_path: torch.Tensor})`` over every entry of every
    shard in ``paths``, in order.  A background thread stays ``prefetch``
    entries ahead: it decodes the next entries and issues their host->device
    copies at once, from pinned memory on a copy stream (see the module
    docstring), so the copies run while the caller's kernels still consume
    the current entry.

    Args:
        paths: shard files (written by :class:`ShardWriter` of either
            package), consumed in the given order.
        prefetch: how many entries may be in flight beyond the one the
            caller holds (2 = classic double buffering).
        sharding: where each leaf goes.  ``None``: ``device``.  A
            ``torch.device`` or a string: there.  A
            :class:`~exciting_environments_torch.parallel.mesh.Placement`
            (split or replicated alike): the mesh's first device, where a
            :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`
            keeps whole trees and splits them at each call.  A callable
            ``(leaf_path, array) -> any of these or None`` chooses per leaf.
        transform: optional host-side ``f(name, arrays) -> arrays`` hook
            (dtype casts, layout tweaks) applied before the copy.
        device: the default device (``sharding=None``, or a callable's
            ``None``): ``cuda:0`` unless given; without CUDA the loader
            raises unless the caller passes ``device="cpu"``.

    Background-thread errors re-raise in the consumer at the equivalent
    ``next()`` call.  Leaving the loop early (``break``) stops the worker:
    the generator's exit joins it and drops every prefetched entry, so no
    pinned buffer or device tensor outlives the generator.
    """

    def __init__(self, paths, prefetch: int = 2, sharding=None, transform=None, device=None):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self.paths = [str(p) for p in paths]
        self.prefetch = int(prefetch)
        self.sharding = sharding
        self.transform = transform
        self.device = device
        if sharding is None:
            self._default_device()  # no CUDA and no device given: raise here, not at the first entry

    def _default_device(self) -> torch.device:
        device = resolve_device(self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        return device

    def _target(self, key, arr) -> torch.device:
        from exciting_environments_torch.parallel.mesh import Placement

        s = self.sharding(key, arr) if callable(self.sharding) else self.sharding
        if s is None:
            return self._default_device()
        if isinstance(s, Placement):
            return s.mesh.devices[0]
        return torch.device(s)

    def _stage(self, arrays, streams):
        """Copy one entry's leaves to their devices: CUDA leaves through a
        pinned buffer and the device's copy stream, CPU leaves as owned
        copies of the read-only views.  Returns the leaves, the ``(device,
        event)`` pair of each copy stream used, and the pinned buffers the
        copies read."""
        batch, pinned, used = {}, [], set()
        for key, arr in arrays.items():
            device = self._target(key, arr)
            if device.type != "cuda":
                batch[key] = torch.from_numpy(np.array(arr)).to(device)
                continue
            host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
            host.numpy()[...] = arr
            if device not in streams:
                streams[device] = torch.cuda.Stream(device=device)
            with torch.cuda.stream(streams[device]):
                batch[key] = host.to(device, non_blocking=True)
            pinned.append(host)
            used.add(device)
        events = []
        for device in used:
            event = torch.cuda.Event()
            event.record(streams[device])
            events.append((device, event))
        return batch, events, pinned

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item):
            """Bounded put that gives up when the consumer is gone: every
            worker put goes through this, or an abandoned iterator leaves the
            thread blocked forever, holding its prefetched device entries."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            streams = {}
            # pinned buffers whose copies may still run, kept until their event has passed
            inflight = collections.deque()
            try:
                for path in self.paths:
                    with ShardIndex(path) as idx:
                        for name, arrays in idx:
                            if stop.is_set():
                                return
                            if self.transform is not None:
                                arrays = self.transform(name, arrays)
                            batch, events, pinned = self._stage(arrays, streams)
                            inflight.append((events, pinned))
                            while inflight and all(e.query() for _, e in inflight[0][0]):
                                inflight.popleft()
                            put_or_stop((name, batch, events))
                            del batch
                put_or_stop(None)
            except BaseException as exc:  # propagate to the consumer
                put_or_stop(exc)
            finally:
                for events, _ in inflight:
                    for _, event in events:
                        event.synchronize()
                inflight.clear()

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                name, batch, events = item
                del item
                for device, event in events:
                    torch.cuda.current_stream(device).wait_event(event)
                for tensor in batch.values():
                    if tensor.device.type == "cuda":
                        tensor.record_stream(torch.cuda.current_stream(tensor.device))
                yield name, batch
                del batch
        finally:
            stop.set()
            thread.join()
            while True:  # drop the entries prefetched past the consumer's exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __len__(self):
        total = 0
        for p in self.paths:
            with ShardIndex(p) as idx:
                total += len(idx)
        return total
