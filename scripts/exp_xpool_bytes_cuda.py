"""Is the X-Pool pair kernel bound by its L2 reads?  One CUDA GPU.

    python3 scripts/exp_xpool_bytes_cuda.py [--rounds 2]

Copies the port into build/exp_xpool_bytes/ (gitignored) with one change to
csrc/xpool_sim_train.cu: the pair kernel's producer loads only the big tf32
halves of its B operands (k_m, u_m^T, Wlin) and the consumers read them in
place of the small halves.  That halves the bytes the kernel reads per tile
and leaves its products, and every other step, as they are (its results are
wrong: it is a timing experiment only).  Then it runs
scripts/time_xpool_cuda.py in this checkout and in the copy in turns (this,
copy, this, copy; `--rounds` times) and prints each run's lines, and the
pair kernel's device time per call in each from one profiled call at
V = M = 2,048.  If the copy runs much faster, bytes bound the kernel.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "exp_xpool_bytes")
SRC = "mgsv_tpu_torch/csrc/xpool_sim_train.cu"
# (what the kernel does, what the copy does instead)
EDITS = [
    ("const uint32_t dst = stage(kQBytes + 2 * kKBytes, bar);",
     "const uint32_t dst = stage(kQBytes + kKBytes, bar);"),
    ("            tma_load_3d(dst + kQBytes + kKBytes, &p.ks, bar, kKs * i, kSc * c, z);\n", ""),
    ("          const uint32_t dst = stage(kStageBytes, bar);\n"
     "          tma_load_3d(dst, &p.ub, bar, kKs * i, 0, z);\n"
     "          tma_load_3d(dst + kSliceBytes, &p.us, bar, kKs * i, 0, z);",
     "          const uint32_t dst = stage(kSliceBytes, bar);\n"
     "          tma_load_3d(dst, &p.ub, bar, kKs * i, 0, z);"),
    ("          const uint32_t dst = stage(kStageBytes, bar);\n"
     "          tma_load_3d(dst, &p.wb, bar, kKs * i, 0, 0);\n"
     "          tma_load_3d(dst + kSliceBytes, &p.ws, bar, kKs * i, 0, 0);",
     "          const uint32_t dst = stage(kSliceBytes, bar);\n"
     "          tma_load_3d(dst, &p.wb, bar, kKs * i, 0, 0);"),
    ("mma_slice<kSc>(part, f, kb, kb + kKBytes, true);", "mma_slice<kSc>(part, f, kb, kb, true);"),
    ("mma_slice<256>(acc, f, bb, bb + kSliceBytes, false);",
     "mma_slice<256>(acc, f, bb, bb, false);"),
]

PAIR_MS = r"""
import sys, torch
sys.path.insert(0, ".")
sys.argv = ["x"]
import importlib.util
spec = importlib.util.spec_from_file_location("t", "scripts/time_xpool_cuda.py")
t = importlib.util.module_from_spec(spec)
spec.loader.exec_module(t)
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
ins = t.inputs(2048, 2048, torch.device("cuda"))
with torch.no_grad():
    xps.xpool_sim_eval(*ins)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        xps.xpool_sim_eval(*ins)
        torch.cuda.synchronize()
ms = sum(e.self_device_time_total for e in prof.key_averages()
         if "xpool_pair_kernel" in e.key) / 1e3
print(f"pair kernel device ms at V=M=2048: {ms:.4f}")
"""


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    os.makedirs(COPY)
    shutil.copytree(os.path.join(ROOT, "mgsv_tpu_torch"), os.path.join(COPY, "mgsv_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "scripts"), os.path.join(COPY, "scripts"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(COPY, SRC)
    with open(path) as f:
        text = f.read()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"{SRC} no longer has: {old.strip()[:70]}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def run(tree: str) -> None:
    for cmd in ([sys.executable, "scripts/time_xpool_cuda.py"], [sys.executable, "-c", PAIR_MS]):
        out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, check=True).stdout
        print(out.strip(), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    make_copy()
    for _ in range(args.rounds):
        for name, tree in (("this checkout", ROOT), ("big halves only", COPY)):
            print(f"== {name}", flush=True)
            run(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
