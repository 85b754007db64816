"""MaDe's paper-branch modules, ported from mgsv_tpu/models/made.py.

`MaDe` holds every submodule of the shipped configuration (XA-music X-Pool,
concat fusion, DETR localization, video moment query, one query) under the
reference Uni_model's state-dict names, so
`mgsv_tpu.interop.torch_export.export_uni_state_dict` output and reference
`.bin` checkpoints load with `strict=True`.  The serving engine drives the
towers, X-Pool, DETR and heads one by one; the training forward
(`MaDe.forward`) comes with the training port (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mgsv_tpu.config import Config
from mgsv_tpu_torch.models import layers as L
from mgsv_tpu_torch.models.detr import DetrTransformer
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.models.xpool import XPoolTransformer


def tower(proj: nn.Linear, temporal: Optional[TemporalTransformer],
          pe: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
          act_after_proj: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame/snippet tower (the JAX `Tower`): mask, project, add the
    sinusoidal table, temporal transformer, mask, masked mean, L2.

    feats [B, L, D_in], mask [B, L] -> (tokens [B, L, D], emb [B, D], mask)."""
    mask = mask.to(feats.dtype)
    x = proj(feats * mask[..., None])
    if act_after_proj:
        x = L.quick_gelu(x)
    if temporal is not None:
        x = temporal(x + pe[None, : x.shape[1]], mask)
        x = x * mask[..., None]
    return x, L.l2_normalize(L.masked_mean(x, mask)), mask


def _unsupported(cfg: Config) -> Optional[str]:
    m = cfg.model
    checks = {
        "agg_module": (m.agg_module, "transf"),
        "with_cls_token": (m.with_cls_token, False),
        "transformer_is_share": (m.transformer_is_share, False),
        "vmr_fusion": (m.vmr_fusion, "XA-music"),
        "mml_fusion": (m.mml_fusion, "concat"),
        "mml_localization": (m.mml_localization, "detr"),
        "detr_pre_norm": (m.detr_pre_norm, False),
        "moment_loss": (m.moment_loss, False),
        "moment_query_type": (m.moment_query_type, "video"),
    }
    bad = [f"{k}={v!r}" for k, (v, want) in checks.items() if v != want]
    return ", ".join(bad) or None


class MaDe(nn.Module):
    """Container of the paper-branch submodules under reference names."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"MaDe port covers the paper branch only; not yet ported: {bad} "
                "(ROADMAP.md, queue 1: variant matrix)")
        self.cfg = cfg
        m, data = cfg.model, cfg.data
        d = m.dim_input
        cdtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else None

        def temporal(depth):
            return (TemporalTransformer(d, depth, m.temporal_heads, m.temporal_mlp_dim,
                                        d, compute_dtype=cdtype) if depth > 0 else None)

        self.vit_proj = nn.Linear(data.vit_dim, d)
        self.ast_proj = nn.Linear(data.ast_dim, d)
        self.video_transformer = temporal(m.video_temporal_depth or m.temporal_depth)
        self.audio_transformer = temporal(m.audio_temporal_depth or m.temporal_depth)
        self.register_buffer("video_pe", torch.from_numpy(
            L.sinusoidal_table(m.video_pe_len, d)), persistent=False)
        self.register_buffer("audio_pe", torch.from_numpy(
            L.sinusoidal_table(m.audio_pe_len, d)), persistent=False)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / m.temperature_init_value)))
        self.video_guided_to_music_pooling_cross_transformer = XPoolTransformer(d)
        self.detr_transformer = DetrTransformer(
            d, m.detr_heads, m.detr_ffn_dim, m.detr_enc_layers, m.detr_dec_layers,
            decoder_self_attn=m.decoder_self_attn)
        self.decoder_query_embed = nn.Embedding(m.num_moment_queries, d)
        self.span_embed = L.DetrMLP(d, d, 1 if m.predict_center else 2, 3)
        self.class_embed = nn.Linear(d, 2)
        if cfg.loss.contrastive_align_loss:
            dc = d if m.audio_short_cut else m.contrastive_dim
            self.contrastive_align_projection_query = nn.Linear(d, dc)
            self.contrastive_align_projection_vid = nn.Linear(d, dc)
        self.reset_parameters(generator or torch.Generator().manual_seed(cfg.train.seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal Dense layers,
        xavier-uniform attention and DETR, identity X-Pool, N(0, 1) query
        embedding, logit_scale = log(1 / temperature)."""
        dense = [self.vit_proj, self.ast_proj, self.class_embed]
        if self.cfg.loss.contrastive_align_loss:
            dense += [self.contrastive_align_projection_query,
                      self.contrastive_align_projection_vid]
        for lin in dense:
            L.lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        for trm in (self.video_transformer, self.audio_transformer):
            if trm is not None:
                trm.reset_parameters(generator)
        self.xpool.reset_parameters()
        self.span_embed.reset_parameters(generator)
        self.detr_transformer.reset_parameters(generator)
        self.decoder_query_embed.weight.normal_(generator=generator)
        self.logit_scale.fill_(math.log(1.0 / self.cfg.model.temperature_init_value))

    def video_tower(self, feats: torch.Tensor, mask: torch.Tensor):
        return tower(self.vit_proj, self.video_transformer, self.video_pe, feats,
                     mask, self.cfg.model.with_act_after_proj)

    def music_tower(self, feats: torch.Tensor, mask: torch.Tensor):
        return tower(self.ast_proj, self.audio_transformer, self.audio_pe, feats,
                     mask, self.cfg.model.with_act_after_proj)

    @property
    def xpool(self) -> XPoolTransformer:
        return self.video_guided_to_music_pooling_cross_transformer
