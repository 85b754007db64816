"""Carry weights into the port: JAX parameter trees and reference `.bin`
checkpoints.

MaDe's go through the reference Uni_model's state-dict names, which the
port's MaDe uses as its own; the frozen towers' flax trees map onto the
port's tower names (flax Dense kernels [in, out] transposed to torch's
[out, in], flax convolution kernels [kh, kw, in, out] to [out, in, kh, kw],
LayerNorm scale to weight).  Every load is `strict=True`, so every port
parameter is covered and no stray entry passes unnoticed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.ast import ASTEncoder
from mgsv_tpu_torch.models.clip_vit import ClipVisionTower
from mgsv_tpu_torch.models.made import MaDe

# Frozen CLIP / AST encoder weights a checkpoint written by the reference
# itself carries besides the trainable head; the port serves precomputed
# features and holds no frozen towers.
FROZEN_PREFIXES = ("clip_model.", "ast_model.")


def load_jax_params(model: MaDe, params: Mapping, cfg: Config) -> MaDe:
    """Load a JAX MaDe parameter tree ({"params": ...} or bare; leaves any
    array numpy reads) into `model`."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in jax_tree_to_state_dict(params, cfg).items()}
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


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": _np(p["kernel"]).T, f"{prefix}.bias": _np(p["bias"])}


def _norm(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": _np(p["scale"]), f"{prefix}.bias": _np(p["bias"])}


def _conv(kernel) -> np.ndarray:
    return _np(kernel).transpose(3, 2, 0, 1)           # [kh, kw, I, O] -> [O, I, kh, kw]


def _vit_blocks(tree: Mapping, prefix: str) -> dict:
    """JAX ViTBlock subtrees block_0, block_1, ... -> `{prefix}.{i}.*`."""
    out, i = {}, 0
    while f"block_{i}" in tree:
        p, b = tree[f"block_{i}"], f"{prefix}.{i}"
        out.update({**_norm(f"{b}.norm1", p["norm1"]),
                    **_dense(f"{b}.attn.qkv", p["attn"]["qkv"]),
                    **_dense(f"{b}.attn.proj", p["attn"]["proj"]),
                    **_norm(f"{b}.norm2", p["norm2"]), **_dense(f"{b}.mlp.fc1", p["fc1"]),
                    **_dense(f"{b}.mlp.fc2", p["fc2"])})
        i += 1
    return out


def _load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in state.items()}, strict=True)
    return module


def load_jax_clip_params(tower: ClipVisionTower, params: Mapping) -> ClipVisionTower:
    """Load a JAX ClipVisionTower parameter tree ({"params": ...} or bare)
    into `tower`."""
    p = params.get("params", params)
    state = {"conv1.weight": _conv(p["conv1"]["kernel"]),
             "class_embedding": _np(p["class_embedding"]),
             "positional_embedding": _np(p["positional_embedding"]),
             "proj": _np(p["proj"]), **_norm("ln_pre", p["ln_pre"]),
             **_norm("ln_post", p["ln_post"]), **_vit_blocks(p, "transformer.resblocks")}
    return _load(tower, state)


def load_jax_ast_params(encoder: ASTEncoder, params: Mapping) -> ASTEncoder:
    """Load a JAX ASTEncoder parameter tree ({"params": ...} or bare) into
    `encoder`."""
    p = params.get("params", params)
    state = {"v.patch_embed.proj.weight": _conv(p["patch_proj"]["kernel"]),
             "v.patch_embed.proj.bias": _np(p["patch_proj"]["bias"]),
             "v.cls_token": _np(p["cls_token"]), "v.dist_token": _np(p["dist_token"]),
             "v.pos_embed": _np(p["pos_embed"]), **_norm("v.norm", p["norm"]),
             **_norm("mlp_head.0", p["head_norm"]), **_dense("mlp_head.1", p["head"]),
             **_vit_blocks(p, "v.blocks")}
    return _load(encoder, state)
