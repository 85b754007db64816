"""The JAX MaDe parameter tree -> reference state-dict names.

The port's `MaDe` uses the reference Uni_model's parameter names and torch
layouts (Linear weight [out, in]; MultiheadAttention packed
in_proj_weight [3D, D]).  `jax_tree_to_state_dict` maps a JAX parameter
tree onto those names; a gradient tree has the same structure, so the same
map carries JAX gradients across for comparison.  It is the key map of the
JAX package's `interop/torch_export.py::export_uni_state_dict`, kept here
so that the port imports nothing of that package (a test holds the two
equal).  Leaves may be any array type numpy can read.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from mgsv_tpu_torch.config import Config

Array = np.ndarray


def _np(x) -> Array:
    return np.ascontiguousarray(np.asarray(x))


def _linear(out: Dict[str, Array], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["kernel"]).T.copy()
    out[f"{prefix}.bias"] = _np(p["bias"])


def _layernorm(out: Dict[str, Array], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _mha(out: Dict[str, Array], prefix: str, p: Mapping) -> None:
    """q/k/v/out Dense params -> torch MultiheadAttention's packed names."""
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_np(p[name]["kernel"]).T for name in ("q_proj", "k_proj", "v_proj")],
        axis=0).copy()
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [_np(p[name]["bias"]) for name in ("q_proj", "k_proj", "v_proj")], axis=0)
    _linear(out, f"{prefix}.out_proj", p["out_proj"])


def _temporal(out: Dict[str, Array], prefix: str, p: Mapping, depth: int) -> None:
    """Transformer_enhancement: ModuleList of [norm1, attn, norm2, ff]."""
    for i in range(depth):
        base = f"{prefix}.layers.{i}"
        _layernorm(out, f"{base}.0", p[f"norm1_{i}"])
        _mha(out, f"{base}.1", p[f"attn_{i}"])
        _layernorm(out, f"{base}.2", p[f"norm2_{i}"])
        _linear(out, f"{base}.3.0", p[f"ff_fc1_{i}"])
        _linear(out, f"{base}.3.3", p[f"ff_fc2_{i}"])
    _linear(out, f"{prefix}.final_linear", p["final_linear"])


def _xpool(out: Dict[str, Array], prefix: str, p: Mapping) -> None:
    for name in ("layer_norm1", "layer_norm2", "layer_norm3"):
        _layernorm(out, f"{prefix}.{name}", p[name])
    _linear(out, f"{prefix}.linear_proj", p["linear_proj"])
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(out, f"{prefix}.cross_attn.{name}", p["cross_attn"][name])


def _cross_transformer(out: Dict[str, Array], prefix: str, p: Mapping,
                       depth: int = 1) -> None:
    for i in range(depth):
        _layernorm(out, f"{prefix}.attention_query_layer_norms.{i}", p[f"q_norm_{i}"])
        _layernorm(out, f"{prefix}.attention_context_layer_norms.{i}", p[f"ctx_norm_{i}"])
        _layernorm(out, f"{prefix}.ff_layer_norms.{i}", p[f"ff_norm_{i}"])
        base = f"{prefix}.layers.{i}"
        ca = p[f"cross_attn_{i}"]
        out[f"{base}.0.to_q.weight"] = np.ascontiguousarray(_np(ca["to_q"]["kernel"]).T)
        out[f"{base}.0.to_kv.weight"] = np.ascontiguousarray(_np(ca["to_kv"]["kernel"]).T)
        _linear(out, f"{base}.0.to_out.0", ca["to_out"])
        _linear(out, f"{base}.1.net.0", p[f"ff_{i}"]["fc1"])
        _linear(out, f"{base}.1.net.3", p[f"ff_{i}"]["fc2"])
    _linear(out, f"{prefix}.final_linear", p["final_linear"])


def _detr(out: Dict[str, Array], prefix: str, p: Mapping, cfg: Config) -> None:
    m = cfg.model
    for i in range(m.detr_enc_layers):
        base = f"{prefix}.encoder.layers.{i}"
        enc = p[f"enc_{i}"]
        _mha(out, f"{base}.self_attn", enc["self_attn"])
        _linear(out, f"{base}.linear1", enc["linear1"])
        _linear(out, f"{base}.linear2", enc["linear2"])
        _layernorm(out, f"{base}.norm1", enc["norm1"])
        _layernorm(out, f"{base}.norm2", enc["norm2"])
    if m.detr_pre_norm and m.detr_enc_layers > 0:
        _layernorm(out, f"{prefix}.encoder.norm", p["encoder_norm"])
    for i in range(m.detr_dec_layers):
        base = f"{prefix}.decoder.layers.{i}"
        dec = p[f"dec_{i}"]
        _mha(out, f"{base}.multihead_attn", dec["multihead_attn"])
        _linear(out, f"{base}.linear1", dec["linear1"])
        _linear(out, f"{base}.linear2", dec["linear2"])
        _layernorm(out, f"{base}.norm2", dec["norm2"])
        _layernorm(out, f"{base}.norm3", dec["norm3"])
        if m.decoder_self_attn or m.detr_pre_norm:
            _mha(out, f"{base}.self_attn", dec["self_attn"])
            _layernorm(out, f"{base}.norm1", dec["norm1"])
    _layernorm(out, f"{prefix}.decoder.norm", p["decoder_norm"])


def jax_tree_to_state_dict(tree: Mapping, cfg: Config) -> Dict[str, Array]:
    """JAX MaDe parameter (or gradient) tree ({"params": ...} or bare) ->
    {reference state-dict name: numpy array}."""
    p = tree["params"] if "params" in tree else tree
    m = cfg.model
    if m.agg_module not in ("transf", "None") or m.with_cls_token:
        raise NotImplementedError(
            f"no key map for agg_module={m.agg_module!r} / "
            f"with_cls_token={m.with_cls_token}")
    out: Dict[str, Array] = {}
    _linear(out, "vit_proj", p["video_tower"]["proj"])
    _linear(out, "ast_proj", p["audio_tower"]["proj"])
    v_depth = m.video_temporal_depth or m.temporal_depth
    a_depth = m.audio_temporal_depth or m.temporal_depth
    if m.agg_module == "transf":
        if m.transformer_is_share:
            if m.temporal_depth > 0:
                _temporal(out, "share_transformer", p["shared_temporal"], m.temporal_depth)
        else:
            if v_depth > 0:
                _temporal(out, "video_transformer", p["video_tower"]["temporal"], v_depth)
            if a_depth > 0:
                _temporal(out, "audio_transformer", p["audio_tower"]["temporal"], a_depth)

    out["logit_scale"] = _np(p["logit_scale"]).reshape(())
    if "XA" in m.vmr_fusion:
        if "music" in m.vmr_fusion:
            _xpool(out, "video_guided_to_music_pooling_cross_transformer", p["xpool_v2m"])
        if "video" in m.vmr_fusion:
            _xpool(out, "music_guided_to_video_pooling_cross_transformer", p["xpool_m2v"])
    if m.mml_fusion == "CA":
        _cross_transformer(out, "video_music_fusion_cross_transformer", p["ca_fusion"])

    _detr(out, "detr_transformer", p["detr"], cfg)
    out["decoder_query_embed.weight"] = _np(p["query_embed"])

    if m.mml_localization == "detr":
        for i in range(3):
            _linear(out, f"span_embed.layers.{i}", p["span_embed"][f"layer_{i}"])
        _linear(out, "class_embed", p["class_embed"])
        if cfg.loss.contrastive_align_loss:
            _linear(out, "contrastive_align_projection_query", p["contrastive_proj_query"])
            _linear(out, "contrastive_align_projection_vid", p["contrastive_proj_vid"])
        if m.moment_loss:
            for i in range(3):
                _linear(out, f"moment_embed.layers.{i}", p["moment_embed"][f"layer_{i}"])
    elif m.mml_localization == "regression":
        for i in range(3):
            _linear(out, f"reg_mlp.layers.{i}", p["reg_mlp"][f"layer_{i}"])
    return out
