"""Build and load the native shard-writer library (counterpart of
``exciting_environments_tpu/io/native.py``; ctypes, no pybind11).

The writer (``native/shard_writer.cpp``, the JAX package's source and C ABI:
``shard_writer_open``, ``_write``, ``_close``, ``_pending``) is compiled on
first use with the host's C++ compiler (``g++`` or ``clang++``) into the
package's build directory (``ops/kernels/stepper.py::BUILD_DIR``,
``exciting_environments_torch/_build/``, shared with the kernel libraries)
under a name that carries a hash of the source and flags, as the kernel
libraries are named (``ops/kernels/stepper.py::_library_path``).  Without a compiler
:func:`native_available` is ``False`` and
:class:`~exciting_environments_torch.io.dataset.ShardWriter` takes its
Python-thread writer, which has the same semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from exciting_environments_torch.ops.kernels.stepper import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "native" / "shard_writer.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"shard_writer_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = _library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or clang++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp_out)], check=True, capture_output=True)
        os.replace(tmp_out, out)  # atomic publish
    return out


_lib = None


def load_native():
    """Load (building if needed) the native library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.shard_writer_open.restype = ctypes.c_void_p
    lib.shard_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.shard_writer_write.restype = ctypes.c_int
    lib.shard_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.shard_writer_close.restype = ctypes.c_uint64
    lib.shard_writer_close.argtypes = [ctypes.c_void_p]
    lib.shard_writer_pending.restype = ctypes.c_uint64
    lib.shard_writer_pending.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except Exception:
        return False
