"""Checkpoints: {params, opt_state, step, epoch[, step_in_epoch]} under
best-metric and `last` tags, ported from mgsv_tpu/core/checkpoint.py.

Each tag is a directory `run_dir/ckpt_<tag>/` holding one `torch.save` file
of CPU tensors and ints.  A save is written into a temporary directory and
renamed into place, so a tag on disk is always complete.  Writes are
synchronous; `wait()` exists for the JAX manager's callers.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict

import torch
from torch import nn

logger = logging.getLogger("mgsv_tpu_torch")

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.run_dir, f"ckpt_{tag}")

    def save(self, tag: str, state: Dict[str, Any]) -> str:
        """state: {"params": state dict, "opt_state": ..., "step", "epoch", ...}
        of CPU tensors and Python numbers.

        The "last" tag, the only resume point, is rotated crash-atomically:
        the committed "last" is renamed to `ckpt_last.prev` before the new
        one is renamed into place, with no deletion in between, and
        restore/exists fall back to `.prev`.  At every instant of a kill a
        complete resume point is on disk once the first save has committed.
        Other tags are replaced after their new copy is complete."""
        path = self._path(tag)
        tmp = f"{path}.tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            if tag == "last":
                prev = path + ".prev"
                if os.path.isdir(prev):
                    shutil.rmtree(prev)
                os.rename(path, prev)
            else:
                shutil.rmtree(path)
        os.rename(tmp, path)
        return path

    def _resolve(self, tag: str) -> str:
        path = self._path(tag)
        if not os.path.isdir(path) and os.path.isdir(path + ".prev"):
            logger.warning(
                "checkpoint %s is missing but its rotation backup exists: a kill "
                "landed between rotation and commit; restoring %s.prev (one save "
                "interval older)", path, path)
            return path + ".prev"
        return path

    def restore(self, tag: str) -> Dict[str, Any]:
        """The saved dict, tensors on the CPU."""
        return torch.load(os.path.join(self._resolve(tag), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def exists(self, tag: str) -> bool:
        return os.path.isdir(self._resolve(tag))

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


class BestMetricTracker:
    """Best-metric checkpoint policy, train-MaDe.py:707-727.

    Tracks R1, R5, mIoU, R1_iou0.5, R1_iou0.7; `update` returns the
    best-checkpoint tags that improved this epoch.
    """

    WATCH = {
        "best_r1": ("R1", True),            # >= keeps latest on ties (:709)
        "best_r5": ("R5", True),            # tracked but not checkpointed (:713)
        "best_iou": ("mIoU", True),
        "best_r1iou05": ("R1_iou0.5", False),  # strict > (:720)
        "best_r1iou07": ("R1_iou0.7", True),
    }
    SAVED = ("best_r1", "best_iou", "best_r1iou05", "best_r1iou07")

    def __init__(self):
        self.best = {tag: {"value": 0.0, "epoch": 0} for tag in self.WATCH}

    def update(self, epoch: int, metrics: Dict[str, float]):
        improved = []
        for tag, (key, ties_keep) in self.WATCH.items():
            value = float(metrics.get(key, 0.0))
            cur = self.best[tag]["value"]
            better = value >= cur if ties_keep else value > cur
            if better:
                self.best[tag] = {"value": value, "epoch": epoch}
                if tag in self.SAVED:
                    improved.append(tag)
        return improved

    def last_best_epoch(self) -> int:
        return max(v["epoch"] for v in self.best.values())

    def should_stop(self, epoch: int, min_epochs: int = 60, patience: int = 20) -> bool:
        """Early stop, train-MaDe.py:735-736."""
        return epoch >= max(min_epochs, self.last_best_epoch() + patience)


def load_weights(model: nn.Module, ckpt: str, run_dir: str, cfg) -> None:
    """Load into `model` a reference-format `.bin` (`pytorch_model.bin.N`
    included) or the weights, running buffers included, of a checkpoint tag
    the port's Trainer wrote under `run_dir` (best_r1, last, epoch_3, ...),
    strictly; what `cli.evaluate` and `cli.index` load."""
    if ckpt.endswith(".bin") or ".bin." in ckpt:
        from mgsv_tpu_torch.interop.from_jax import load_reference_bin
        model.load_state_dict(load_reference_bin(ckpt, cfg).state_dict(), strict=True)
        return
    mgr = CheckpointManager(run_dir)
    if not mgr.exists(ckpt):
        raise FileNotFoundError(f"no checkpoint {ckpt!r} under {run_dir}")
    model.load_state_dict(mgr.restore(ckpt)["params"], strict=True)
