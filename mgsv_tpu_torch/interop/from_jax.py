"""Carry weights into the port: JAX variable trees and reference `.bin`
checkpoints.

MaDe's go through the reference Uni_model's state-dict names, which the
port's MaDe uses as its own; the frozen towers' flax trees map onto the
port's tower names (flax Dense kernels [in, out] transposed to torch's
[out, in], flax convolution kernels [kh, kw, in, out] to [out, in, kh, kw],
LayerNorm scale to weight).  Every load is `strict=True`, so every port
parameter is covered and no stray entry passes unnoticed.

The cls tokens and the EmbeddingNets (agg_module="mlp") have no reference
names known: the JAX package's torch export and import refuse them.  Their
names below are the port's own (`video_cls_token`,
`audio_embedding_net.net.4.running_var`, ...), and a reference `.bin`
neither carries nor takes them (`check_reference_format`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

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
# JAX tower subtree -> the port's prefix of its cls token and EmbeddingNet
_TOWERS = {"video_tower": "video", "audio_tower": "audio"}
# JAX EmbeddingNet names -> the reference Sequential's indices (Linear,
# BatchNorm, ReLU, Linear, BatchNorm, ReLU, Linear)
_EMBEDDING_DENSE = {"fc1": "net.0", "fc2": "net.3", "fc3": "net.6"}
_EMBEDDING_NORM = {"bn1": "net.1", "bn2": "net.4"}


def check_reference_format(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration that a reference-format
    checkpoint cannot hold, where the JAX package's torch export and import
    raise (interop/torch_export.py, torch_import.py): the EmbeddingNet
    aggregator and the cls token."""
    m = cfg.model
    if m.agg_module not in ("transf", "None") or m.with_cls_token:
        raise NotImplementedError(
            f"no reference-format checkpoint for agg_module={m.agg_module!r} / "
            f"with_cls_token={m.with_cls_token}: the reference's names of the EmbeddingNets "
            "and cls tokens are not known (the JAX package's export and import refuse them "
            "too); use the port's own checkpoint, a tag under --run-dir")


def _tower_keys(cfg: Config) -> set:
    """The subtrees a JAX tower of cfg holds."""
    m = cfg.model
    depth = {"video_tower": m.video_temporal_depth, "audio_tower": m.audio_temporal_depth}
    keys = {"proj"}
    if m.with_cls_token:
        keys.add("cls_token")
    if m.agg_module == "mlp":
        keys.add("embedding_net")
    return {name: keys | ({"temporal"} if m.agg_module == "transf" and not
                          m.transformer_is_share and (depth[name] or m.temporal_depth) > 0
                          else set()) for name in _TOWERS}


def jax_variables_to_state_dict(tree: Mapping, cfg: Config) -> Dict[str, np.ndarray]:
    """A JAX MaDe variable tree ({"params": ...[, "batch_stats": ...]} or
    bare params; a gradient tree alike) -> {port state-dict name: array}:
    interop/state_dict.py's reference key map, and the port's own names for
    the cls tokens, the EmbeddingNets and their running buffers (JAX's
    "batch_stats", whose [L, 1] BatchNorm leaves become [L]).  Raises
    KeyError where a tower holds a subtree the configuration does not
    build, or batch_stats come without the EmbeddingNet."""
    params = tree["params"] if "params" in tree else tree
    m = cfg.model
    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, agg_module="None" if m.agg_module == "mlp" else m.agg_module, with_cls_token=False))
    out = jax_tree_to_state_dict(params, ref_cfg)
    for name, keys in _tower_keys(cfg).items():
        if set(params[name]) != keys:
            raise KeyError(f"JAX {name} holds {sorted(params[name])}, the configuration "
                           f"builds {sorted(keys)}")
    stats = tree.get("batch_stats") if "params" in tree else None
    if stats is not None and m.agg_module != "mlp":
        raise KeyError(f"batch_stats given, but agg_module={m.agg_module!r} keeps none")
    for name, port in _TOWERS.items():
        sub = params[name]
        if m.with_cls_token:
            out[f"{port}_cls_token"] = _np(sub["cls_token"])
        if m.agg_module == "mlp":
            out.update(embedding_net_state(
                sub["embedding_net"],
                stats[name]["embedding_net"] if stats is not None else None,
                f"{port}_embedding_net."))
    return out


def embedding_net_state(params: Mapping, stats: Optional[Mapping] = None,
                        prefix: str = "") -> dict:
    """A JAX EmbeddingNet's params (and its batch_stats) -> the port's
    EmbeddingNet names under `prefix`: fc1/fc2/fc3 -> net.0/net.3/net.6,
    bn1/bn2 -> net.1/net.4 (scale -> weight, mean and var -> running_mean
    and running_var, [L, 1] -> [L])."""
    out = {}
    for jname, idx in _EMBEDDING_DENSE.items():
        out.update(_dense(f"{prefix}{idx}", params[jname]))
    for jname, idx in _EMBEDDING_NORM.items():
        out[f"{prefix}{idx}.weight"] = _np(params[f"{jname}_scale"])[:, 0]
        out[f"{prefix}{idx}.bias"] = _np(params[f"{jname}_bias"])[:, 0]
        if stats is not None:
            out[f"{prefix}{idx}.running_mean"] = _np(stats[f"{jname}_mean"])[:, 0]
            out[f"{prefix}{idx}.running_var"] = _np(stats[f"{jname}_var"])[:, 0]
    return out


def load_jax_params(model: MaDe, params: Mapping, cfg: Config) -> MaDe:
    """Load a JAX MaDe variable tree ({"params": ...} with "batch_stats"
    for agg_module="mlp", or bare params; leaves any array numpy reads)
    into `model`, strictly."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in jax_variables_to_state_dict(params, cfg).items()}
    model.load_state_dict(state, strict=True)
    return model


def load_reference_bin(path: str, cfg: Config) -> MaDe:
    """A MaDe (on the CPU) with the weights of a reference-format checkpoint:
    `{"model_state_dict": ...}` as `mgsv_tpu.cli.evaluate --export-torch` and
    the reference write it, or a bare state dict.  Raises where
    `check_reference_format` does."""
    check_reference_format(cfg)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model_state_dict", blob)
    state = {k: v for k, v in state.items() if not k.startswith(FROZEN_PREFIXES)}
    model = MaDe(cfg)
    model.load_state_dict(state, strict=True)
    return model


def save_reference_bin(model: MaDe, cfg: Config, path: str) -> None:
    """Write `model` as a reference-format checkpoint at `path`, as the
    reference and `mgsv_tpu.cli.evaluate --export-torch` write one.  Raises
    where `check_reference_format` does."""
    check_reference_format(cfg)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "loss": 0.0, "model_state_dict": state}, path)


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
