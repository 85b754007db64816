"""ctypes bindings and the build at first use of the native gather
(`mgsv_io.cc`, a copy of the JAX package's `mgsv_tpu/runtime/mgsv_io.cc`):
an mmap of one packed `.npy` array with a threaded row gather that widens
float16 to float32 in the same pass, and row prefetch by madvise.

The library is compiled with g++ at its first use in a process into
`mgsv_tpu_torch/_build/libmgsv_io-<hash>.so`, the hash covering the source
and the flags, so an edited source is rebuilt and an unchanged one reused.
There is no fallback: a store that asks for the native gather raises, with
the compiler's output, when the library cannot be built or loaded.  Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from mgsv_tpu_torch.runtime.kernels import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mgsv_io.cc")
# No -march=native (the JAX package's flag): a library in the checkout may be
# loaded on another host's CPU, and the widening copy is no slower without it.
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmgsv_io-{h.hexdigest()[:16]}.so")


def build(timeout: float = 120) -> str:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with g++'s output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native gather: {' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native gather: g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)          # atomic: concurrent builds leave one whole file
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mgsv_open_store.restype = ctypes.c_void_p
            lib.mgsv_open_store.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64]
            lib.mgsv_close_store.restype = None
            lib.mgsv_close_store.argtypes = [ctypes.c_void_p]
            for fn in (lib.mgsv_gather, lib.mgsv_gather_f16_to_f32):
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int]
            lib.mgsv_prefetch_rows.restype = None
            lib.mgsv_prefetch_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_int64]
            _lib = lib
        return _lib


def npy_layout(path: str):
    """(byte offset of the raw data, shape, dtype) of a C-order .npy file."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        major, _ = fmt.read_magic(f)
        if major not in (1, 2):
            raise ValueError(f"{path}: .npy format version {major} is not read here")
        read = fmt.read_array_header_1_0 if major == 1 else fmt.read_array_header_2_0
        shape, fortran_order, dtype = read(f)
        if fortran_order:
            raise ValueError(f"{path}: Fortran-order arrays cannot be gathered by row")
        return f.tell(), tuple(shape), np.dtype(dtype)


class NativeStore:
    """Row-gatherable view of one packed C-order .npy array file."""

    def __init__(self, path: str, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.rows = self.shape[0]
        self.row_elems = int(np.prod(self.shape[1:], dtype=np.int64))
        self.row_bytes = self.row_elems * self.dtype.itemsize
        self._handle = None
        offset, file_shape, file_dtype = npy_layout(path)
        if (file_shape, file_dtype) != (self.shape, self.dtype):
            raise ValueError(f"{path} holds {file_shape} {file_dtype}, its metadata says "
                             f"{self.shape} {self.dtype}")
        # the gather is a raw memcpy: a file shorter than its metadata says
        # would be read past its end
        need = offset + self.rows * self.row_bytes
        if os.path.getsize(path) < need:
            raise ValueError(f"{path}: {os.path.getsize(path)} bytes, the shape "
                             f"{self.shape} of {self.dtype} needs {need}")
        self._lib = get_lib()
        self._handle = self._lib.mgsv_open_store(path.encode(), offset, self.rows,
                                                 self.row_bytes)
        if not self._handle:
            raise OSError(f"native gather: cannot open and map {path}")

    def _checked(self, idx) -> np.ndarray:
        idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.rows):
            # a bad index would read outside the mapping instead of raising
            raise IndexError(f"gather indices out of range [0, {self.rows}): "
                             f"min={idx.min()} max={idx.max()}")
        return idx

    def gather(self, idx, out_dtype=np.float32, threads: int = 0) -> np.ndarray:
        """Rows `idx` as a new [len(idx), *shape[1:]] array of out_dtype
        (None: the storage dtype).  float16 -> float32 is widened inside the
        copy; any other conversion is a numpy cast of the gathered rows."""
        if self._handle is None:
            raise ValueError("gather on a closed store")
        out_dtype = self.dtype if out_dtype is None else np.dtype(out_dtype)
        idx = self._checked(idx)
        n = len(idx)
        threads = threads or min(4, os.cpu_count() or 1)
        widen = self.dtype == np.float16 and out_dtype == np.float32
        out = np.empty((n, self.row_elems), np.float32 if widen else self.dtype)
        fn = self._lib.mgsv_gather_f16_to_f32 if widen else self._lib.mgsv_gather
        fn(self._handle, idx.ctypes.data_as(ctypes.c_void_p), n,
           out.ctypes.data_as(ctypes.c_void_p), threads)
        out = out.reshape((n,) + self.shape[1:])
        return out if out.dtype == out_dtype else out.astype(out_dtype)

    def prefetch(self, idx) -> None:
        """Ask the kernel to read the pages of rows `idx` ahead."""
        if self._handle is None:
            raise ValueError("prefetch on a closed store")
        idx = self._checked(idx)
        self._lib.mgsv_prefetch_rows(self._handle, idx.ctypes.data_as(ctypes.c_void_p),
                                     len(idx))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.mgsv_close_store(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
