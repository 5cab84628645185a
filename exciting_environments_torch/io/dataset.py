"""Self-describing binary shards for trajectory trees (counterpart of
``exciting_environments_tpu/io/dataset.py``).

Format (little-endian), the JAX package's byte for byte:
  magic ``EXTPU1\\n`` | raw leaf bytes... | header JSON | uint64 header_len | magic

The header records, per appended tree: the leaf key paths (the strings
``jax.tree_util.keystr`` gives for the same tree in the JAX package, from
:func:`~exciting_environments_torch.utils.checkpoint.leaves_with_path`),
dtypes, shapes and byte offsets, so :func:`read_shard` rebuilds plain dicts
with NumPy alone.  A shard written by either package from the same data is
the same file, and each package reads the other's.

Leaves are written as the JAX package writes the same tree: a tensor as its
host array (a key of :mod:`~exciting_environments_torch.ops.random`, int64
``(..., 2)`` words, as JAX's uint32 words); a Python-scalar field of a state
(a fresh state's ``active_solver_state=False``) broadcast over the state's
batch shape, as JAX's vmapped state holds it; every leaf through
``np.ascontiguousarray``, which makes a 0-d leaf (a dict's Python float, a
0-d tensor) a ``(1,)`` array, as it does in the JAX package.  ``bfloat16``
has no NumPy type without ``ml_dtypes``, so such a leaf raises a
``TypeError`` that names it.

Writing goes through the native asynchronous writer (C++ background thread,
bounded queue, :mod:`~exciting_environments_torch.io.native`) when a host
compiler is available, else a Python-thread writer with the same behaviour.
"""

from __future__ import annotations

import json
import queue
import struct
import threading

import numpy as np
import torch

from exciting_environments_torch.io import native as _native
from exciting_environments_torch.utils.checkpoint import _stored, leaves_with_path, scalar_shapes

MAGIC = b"EXTPU1\n"


def host_leaves(tree):
    """``[(path, np.ndarray)]`` of ``tree`` as a shard stores it (see the
    module docstring): JAX key paths and leaf order, contiguous host
    arrays of the JAX package's dtypes and shapes."""
    out = []
    for (path, leaf), shape in zip(leaves_with_path(tree), scalar_shapes(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"leaf {path!r} is bfloat16, which NumPy cannot name without ml_dtypes; cast it (e.g. to "
                "float32) before appending it to a shard"
            )
        out.append((path, np.ascontiguousarray(_stored(path, leaf, shape))))
    return out


class _PyAsyncWriter:
    """Python-thread writer mirroring the native writer's semantics:
    bounded in-flight bytes (the producer blocks past ``max_queue_bytes``)
    and drain-thread IO errors re-raised at the next ``write``/``close``."""

    def __init__(self, path, max_queue_bytes):
        self._f = open(path, "wb")
        self._q = queue.Queue()
        self._max = max_queue_bytes
        self._pending = 0
        self._error = None
        self._cond = threading.Condition()
        self._written = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            buf = self._q.get()
            if buf is None:
                return
            try:
                self._f.write(buf)
            except OSError as exc:
                with self._cond:
                    self._error = exc
                    self._pending = 0
                    self._cond.notify_all()
                return
            with self._cond:
                self._pending -= len(buf)
                self._written += len(buf)
                self._cond.notify_all()

    def write(self, data: bytes):
        with self._cond:
            # backpressure: block until the disk catches up (or the drain
            # thread reports an error); a single buffer larger than the
            # bound is admitted once the queue is drained
            while self._error is None and self._pending > 0 and self._pending + len(data) > self._max:
                self._cond.wait()
            if self._error is not None:
                raise OSError("shard writer hit an IO error") from self._error
            self._pending += len(data)
        self._q.put(data)

    def close(self) -> int:
        self._q.put(None)
        self._thread.join()
        self._f.close()
        if self._error is not None:
            raise OSError("shard writer hit an IO error") from self._error
        return self._written

    def pending(self) -> int:
        with self._cond:
            return self._pending


class _NativeWriter:
    def __init__(self, path, max_queue_bytes):
        self._lib = _native.load_native()
        self._h = self._lib.shard_writer_open(str(path).encode(), max_queue_bytes)
        if not self._h:
            raise OSError(f"cannot open shard {path!r}")
        self._closed = False

    def write(self, data: bytes):
        rc = self._lib.shard_writer_write(self._h, data, len(data))
        if rc != 0:
            raise OSError("shard writer rejected data (closing or IO error)")

    def close(self) -> int:
        if self._closed:
            return 0
        self._closed = True
        written = self._lib.shard_writer_close(self._h)
        if written == 2**64 - 1:
            raise OSError("shard writer hit an IO error")
        return written

    def pending(self) -> int:
        return self._lib.shard_writer_pending(self._h)


class ShardWriter:
    """Stream trajectory trees into one binary shard, asynchronously.

    Usage::

        with ShardWriter("run0.extpu") as w:
            for _ in range(n_rollouts):
                traj, state = collector.collect(state, next_signal())
                w.append(traj)          # device->host copy + enqueue; disk IO
                                        # overlaps the next rollout

    Args:
        path: output file.
        max_queue_bytes: bound on in-flight buffered bytes (a producer
            appending past it blocks until the disk catches up).
        use_native: force the native/Python backend (default: native when a
            host C++ compiler is available).
    """

    def __init__(self, path, max_queue_bytes: int = 1 << 30, use_native: bool = None):
        if use_native is None:
            use_native = _native.native_available()
        self.native = bool(use_native)
        self._writer = (_NativeWriter if self.native else _PyAsyncWriter)(path, max_queue_bytes)
        self._entries = []
        self._data_offset = 0
        self._closed = False
        self._written = 0
        # leading magic streams immediately; the header travels in a footer so
        # payloads never need re-buffering
        self._writer.write(MAGIC)

    def append(self, tree, name: str = None):
        """Append one tree (a ``TrajectoryBatch``, a state, a dict of
        tensors); leaves are copied to the host and enqueued for background
        writing."""
        leaves = []
        for path, arr in host_leaves(tree):
            leaves.append(
                {
                    "path": path,
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "offset": self._data_offset,
                    "nbytes": int(arr.nbytes),
                }
            )
            self._writer.write(arr.tobytes())
            self._data_offset += arr.nbytes
        self._entries.append({"name": name or f"entry_{len(self._entries)}", "leaves": leaves})

    @property
    def pending_bytes(self) -> int:
        return self._writer.pending()

    def close(self) -> int:
        """Write the footer (header JSON + its length + magic), flush, return
        total bytes written.  Idempotent."""
        if self._closed:
            return self._written
        self._closed = True
        header = json.dumps({"entries": self._entries}).encode()
        self._writer.write(header)
        self._writer.write(struct.pack("<Q", len(header)))
        self._writer.write(MAGIC)
        self._written = self._writer.close()
        return self._written

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_shard(path):
    """Load a shard written by :class:`ShardWriter` (of either package).

    Returns a list of ``(name, {leaf_path: np.ndarray})`` in append order.
    The format logic lives in :class:`~exciting_environments_torch.io.loader.ShardIndex`
    (imported lazily: the loader depends on this module for ``MAGIC``).
    """
    from exciting_environments_torch.io.loader import read_shard_lazy

    return list(read_shard_lazy(path))
