"""Build-at-first-use loader for the port's CUDA kernels.

Each `mgsv_tpu_torch/csrc/<name>.cu` exposes a plain C interface.  At its
first use in a process it is compiled with nvcc for Hopper (sm_90a) into
`mgsv_tpu_torch/_build/lib<name>-<hash>.so` and loaded with ctypes; the hash
covers the sources and the flags, so an edited source is rebuilt and an
unchanged one is reused.  `build_all` compiles several sources at once, one
nvcc process each.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills into the build log (`build_logs`); it does not change the code.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("fused_encoder_layer", "fused_encoder_layer_bwd", "xpool_sim_train",
           "flash_attention", "fused_temporal_layer", "fused_temporal_layer_bwd",
           "fused_decoder_layer", "fused_decoder_layer_bwd")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on the machine with the GPU")
    return path


def _source_hash(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _library(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    return os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(src)}.so")


def build_all(names: Sequence[str] = KERNELS, timeout: float = 600) -> Dict[str, str]:
    """Compile every csrc/<name>.cu that has no library yet, all nvcc
    processes started together; return {name: library path}."""
    libs = {name: _library(name) for name in names}
    todo = {name: so for name, so in libs.items() if not os.path.exists(so)}
    if not todo:
        return libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, procs = nvcc_path(), {}
    try:
        for name, so in todo.items():
            cmd = [nvcc, *NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp",
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=timeout)
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            else:
                os.replace(f"{todo[name]}.{os.getpid()}.tmp", todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build_all([name])[name])
        return lib


def load_initialized(name: str, device_index: int) -> ctypes.CDLL:
    """`load(name)` after its `mgsv_<name>_init` ran on the current device
    (it sets the kernels' shared-memory limits there; call with that
    device current, once per device).  Raises on a CUDA error."""
    lib = load(name)
    init = getattr(lib, f"mgsv_{name}_init")
    init.restype = ctypes.c_int
    err = init()
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} in init on cuda:{device_index}")
    return lib
