"""Carry weights into the port: JAX parameter trees and reference `.bin`
checkpoints.

Both go through the reference Uni_model's state-dict names, which the
port's MaDe uses as its own, and both load with `strict=True`, so every
port parameter is covered and no stray entry passes unnoticed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mgsv_tpu.config import Config
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu_torch.models.made import MaDe

# Frozen CLIP / AST encoder weights a checkpoint written by the reference
# itself carries besides the trainable head; the port serves precomputed
# features and holds no frozen towers.
FROZEN_PREFIXES = ("clip_model.", "ast_model.")


def load_jax_params(model: MaDe, params: Mapping, cfg: Config) -> MaDe:
    """Load a JAX MaDe parameter tree ({"params": ...} or bare) into `model`."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in export_uni_state_dict(params, cfg).items()}
    model.load_state_dict(state, strict=True)
    return model


def load_reference_bin(path: str, cfg: Config) -> MaDe:
    """A MaDe (on the CPU) with the weights of a reference-format checkpoint:
    `{"model_state_dict": ...}` as `mgsv_tpu.cli.evaluate --export-torch` and
    the reference write it, or a bare state dict."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model_state_dict", blob)
    state = {k: v for k, v in state.items() if not k.startswith(FROZEN_PREFIXES)}
    model = MaDe(cfg)
    model.load_state_dict(state, strict=True)
    return model
