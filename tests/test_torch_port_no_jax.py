"""The port runs where JAX, flax, pandas and tensorboardX are absent (the GPU
machine may lack them) and imports nothing of the JAX package: a fresh
interpreter in which importing them, or the top-level package `mgsv_tpu`,
fails imports
every mgsv_tpu_torch module (core/flops.py and interop/from_jax.py's
jax_opt_state_to_port among them), chip_smoke.py and the scripts that drive
the port on the card (scripts/profile_{serving,train,eval}_cuda.py,
scripts/time_{encoder_layer,xpool,layers}_cuda.py, scripts/ab_kernels_cuda.py).
The CPU-side scripts, which hold the port to JAX or carry JAX's state
across, import JAX by design and fail there."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "tensorboardX", "mgsv_tpu")

# the scripts that run where both packages are installed (the CPU), never
# on the card
CPU_SIDE = ("scripts/ab_port_vs_jax.py", "scripts/convert_jax_run.py")

_SCRIPT = r"""
import importlib, pkgutil, runpy, sys

BLOCKED = %r
CPU_SIDE = %r

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:       # exact: mgsv_tpu_torch passes
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, _Block())
import mgsv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mgsv_tpu_torch.__path__, "mgsv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"mgsv_tpu_torch.ops.lsap", "mgsv_tpu_torch.ops.cuda.fused_decoder_layer",
        "mgsv_tpu_torch.runtime.native", "mgsv_tpu_torch.data.device_data",
        "mgsv_tpu_torch.models.cross", "mgsv_tpu_torch.models.embedding_net",
        "mgsv_tpu_torch.core.flops", "mgsv_tpu_torch.interop.from_jax"} <= set(names)
from mgsv_tpu_torch.core.flops import peak_tflops, train_step_flops
from mgsv_tpu_torch.interop.from_jax import jax_opt_state_to_port
import chip_smoke
for script in ("scripts/profile_serving_cuda.py", "scripts/profile_train_cuda.py",
               "scripts/profile_eval_cuda.py",
               "scripts/time_encoder_layer_cuda.py", "scripts/time_xpool_cuda.py",
               "scripts/time_layers_cuda.py", "scripts/ab_kernels_cuda.py"):
    runpy.run_path(script, run_name="not_main")
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
for script in CPU_SIDE:
    try:
        runpy.run_path(script, run_name="not_main")
    except ImportError:
        continue
    raise AssertionError(f"{script} ran without JAX")
print(len(names))
""" % (_BLOCKED, CPU_SIDE)


def test_port_imports_without_jax_flax_pandas():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 65     # every module walked


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device the smoke run fails and prints no result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
