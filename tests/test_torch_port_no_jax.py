"""The port runs where JAX, flax and pandas are absent (the GPU machine's
environment): a fresh interpreter in which importing them fails imports
every mgsv_tpu_torch module and chip_smoke.py."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, _Block())
import mgsv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mgsv_tpu_torch.__path__, "mgsv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pandas")]
print(len(names))
"""


def test_port_imports_without_jax_flax_pandas():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15     # every module walked


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device the smoke run fails and prints no result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
