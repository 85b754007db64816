"""MaDe, ported from mgsv_tpu/models/made.py.

`MaDe` holds the submodules its configuration builds under the reference
Uni_model's state-dict names, so JAX parameter trees (through
`interop/state_dict.py`) and reference `.bin` checkpoints load with
`strict=True`: the towers' temporal stacks (one shared stack,
`share_transformer`, under transformer_is_share), the X-Pools of
`vmr_fusion` (video-guided music pooling for XA-music, music-guided video
pooling for XA-video, both for XA-music-video, none for NO), the CA fusion
(models/cross.py) or concat, the pre- or post-norm DETR, and DETR heads
(with moment_loss's moment head) or the regression head.  The serving
engine drives the towers, X-Pool, DETR and heads one by one; `MaDe.forward`
is the training forward of the JAX `MaDe`, with the X-Pool similarity and
the post-norm DETR encoder layers on the CUDA kernels (their plain versions
on CPU tensors; the encoder at bf16 precision under a bf16 compute dtype,
and its plain layers under autocast with `fused_detr_encoder=False` or in
pre-norm, as in JAX), with `fused_temporal` the temporal towers' layers too
(FusedTemporalTransformer, float32, as in JAX; a shared stack runs both
towers through one set of weights), and with the call argument
`fused_decoder` the post-norm DETR decoder's layers (float32, no dropout,
as JAX's FusedDetrDecoderLayer).  Each tower aggregates its tokens with its
temporal stack (agg_module "transf"), with an EmbeddingNet (models/
embedding_net.py, "mlp") or with neither ("None"), and with
`with_cls_token` prepends a learned cls token whose output row is the
tower's embedding.  Those modules have no reference names known, so they
take the port's own (`video_cls_token`, `audio_cls_token`,
`video_embedding_net`, `audio_embedding_net`), and a reference `.bin` does
not carry them (interop/from_jax.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models import layers as L
from mgsv_tpu_torch.models.cross import CrossTransformer
from mgsv_tpu_torch.models.detr import DetrTransformer
from mgsv_tpu_torch.models.embedding_net import EmbeddingNet
from mgsv_tpu_torch.models.temporal import FusedTemporalTransformer, TemporalTransformer
from mgsv_tpu_torch.models.xpool import XPoolTransformer


def tower(proj: nn.Linear, temporal: Optional[TemporalTransformer],
          pe: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
          act_after_proj: bool = False, generator: Optional[torch.Generator] = None,
          plain_temporal: bool = False, cls_token: Optional[torch.Tensor] = None,
          embedding_net: Optional[EmbeddingNet] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame/snippet tower (the JAX `Tower`): mask, project, with
    `cls_token` [1, 1, D] prepend it (a valid mask column), then the
    temporal transformer over the sinusoidal table (dropout only with a
    generator; its plain layers with `plain_temporal`, as a JAX `Tower`
    without `fused`) or the EmbeddingNet (batch statistics only with a
    generator), mask, and L2 of the cls row or of the masked mean.

    feats [B, L, D_in], mask [B, L] -> (tokens [B, L, D], emb [B, D], mask),
    the tokens and mask without the cls row."""
    mask = mask.to(feats.dtype)
    x = proj(feats * mask[..., None])
    if act_after_proj:
        x = L.quick_gelu(x)
    if cls_token is not None:
        x = torch.cat([cls_token.to(x.dtype).expand(x.shape[0], 1, -1), x], dim=1)
        mask = torch.cat([mask.new_ones(mask.shape[0], 1), mask], dim=1)
    if temporal is not None:
        run = temporal.plain_forward if plain_temporal else temporal
        x = run(x + pe[None, : x.shape[1]], mask, generator)
        x = x * mask[..., None]
    elif embedding_net is not None:
        x = embedding_net(x, training=generator is not None) * mask[..., None]
    if cls_token is not None:
        return x[:, 1:], L.l2_normalize(x[:, 0]), mask[:, 1:]
    return x, L.l2_normalize(L.masked_mean(x, mask)), mask


def uses_fused_sim(cfg: Config) -> bool:
    """Whether the training forward takes the [V, M] X-Pool similarity
    straight from the X-Pool kernel: only where nothing but that similarity
    is consumed (JAX made.py:180-184)."""
    m = cfg.model
    return (m.fused_xpool_sim and m.vmr_fusion == "XA-music"
            and cfg.loss.vmr_loss in ("single", "dual_single_loss_fuse", "dual_single_sim_fuse")
            and m.moment_query_type != "xpool")


class MaDe(nn.Module):
    """Container of MaDe's submodules under reference names."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        m, data = cfg.model, cfg.data
        d = m.dim_input
        cdtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else None
        self.compute_dtype = cdtype
        self.use_fused_sim = uses_fused_sim(cfg)
        music_pool = "XA" in m.vmr_fusion and "music" in m.vmr_fusion
        if m.moment_query_type == "xpool" and not music_pool:
            raise ValueError(f"moment_query_type='xpool' takes the video-guided music X-Pool, "
                             f"which vmr_fusion={m.vmr_fusion!r} does not build")

        # fused_temporal: both towers on the fused temporal-layer kernel
        # (JAX made.py: Tower(fused=m.fused_temporal))
        trm = FusedTemporalTransformer if m.fused_temporal else TemporalTransformer

        def temporal(depth):
            return (trm(d, depth, m.temporal_heads, m.temporal_mlp_dim, d,
                        compute_dtype=cdtype, dropout=m.temporal_dropout)
                    if depth > 0 else None)

        self.vit_proj = nn.Linear(data.vit_dim, d)
        self.ast_proj = nn.Linear(data.ast_dim, d)
        v_depth = m.video_temporal_depth or m.temporal_depth
        a_depth = m.audio_temporal_depth or m.temporal_depth
        if m.agg_module not in ("transf", "mlp", "None"):
            raise ValueError(f"unsupported agg_module: {m.agg_module!r}")
        if m.transformer_is_share and not v_depth == a_depth == m.temporal_depth:
            raise ValueError("transformer_is_share uses one temporal stack; per-tower "
                             f"depths {v_depth} / {a_depth} cannot apply")
        if m.agg_module == "transf" and m.transformer_is_share:
            # one temporal stack for both towers (each adds its own table)
            self.share_transformer = temporal(m.temporal_depth)
        elif m.agg_module == "transf":
            self.video_transformer = temporal(v_depth)
            self.audio_transformer = temporal(a_depth)
        # the sequence lengths the towers see: frames or snippets, and the cls row
        extra = int(m.with_cls_token)
        if m.agg_module == "mlp":
            self.video_embedding_net = EmbeddingNet(d, data.max_v_frames + extra)
            self.audio_embedding_net = EmbeddingNet(d, data.max_snippet_num + extra)
        if m.with_cls_token:
            self.video_cls_token = nn.Parameter(torch.zeros(1, 1, d))
            self.audio_cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.register_buffer("video_pe", torch.from_numpy(
            L.sinusoidal_table(m.video_pe_len, d)), persistent=False)
        self.register_buffer("audio_pe", torch.from_numpy(
            L.sinusoidal_table(m.audio_pe_len, d)), persistent=False)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / m.temperature_init_value)))
        if music_pool:          # video embeddings pool each track's snippets: [M, V, D]
            self.video_guided_to_music_pooling_cross_transformer = XPoolTransformer(
                d, m.xpool_dropout)
        if "XA" in m.vmr_fusion and "video" in m.vmr_fusion:
            # music embeddings pool each video's frames: [V, M, D]
            self.music_guided_to_video_pooling_cross_transformer = XPoolTransformer(
                d, m.xpool_dropout)
        if m.mml_fusion == "CA":
            self.video_music_fusion_cross_transformer = CrossTransformer(
                d, depth=1, heads=m.ca_heads, dim_head=m.ca_dim_head, mlp_dim=m.ca_mlp_dim,
                out_dim=d, dropout=m.ca_dropout)
        elif m.mml_fusion != "concat":
            raise ValueError(f"unsupported mml_fusion: {m.mml_fusion}")
        self.detr_transformer = DetrTransformer(
            d, m.detr_heads, m.detr_ffn_dim, m.detr_enc_layers, m.detr_dec_layers,
            decoder_self_attn=m.decoder_self_attn, pre_norm=m.detr_pre_norm,
            dropout=m.detr_dropout)
        self.decoder_query_embed = nn.Embedding(m.num_moment_queries, d)
        self.detr_heads = m.mml_localization == "detr"
        if self.detr_heads:
            self.span_embed = L.DetrMLP(d, d, 1 if m.predict_center else 2, 3)
            self.class_embed = nn.Linear(d, 2)
            if cfg.loss.contrastive_align_loss:
                dc = d if m.audio_short_cut else m.contrastive_dim
                self.contrastive_align_projection_query = nn.Linear(d, dc)
                self.contrastive_align_projection_vid = nn.Linear(d, dc)
            if m.moment_loss:
                self.moment_embed = L.DetrMLP(d, d, d, 3)
        elif m.mml_localization == "regression":
            # masked mean of the memory -> MLP (hidden 256 whatever D, as JAX)
            self.reg_mlp = L.DetrMLP(d, 256, 1 if m.predict_center else 2, 3)
        else:
            raise ValueError(f"unsupported mml_localization: {m.mml_localization}")
        self.reset_parameters(generator or torch.Generator().manual_seed(cfg.train.seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: lecun-normal Dense layers and MLP
        heads, xavier-uniform attention and DETR, xavier-normal CA fusion and
        EmbeddingNets, identity X-Pool, N(0, 1) query embedding, cls tokens
        N(0, 0.02) truncated at two deviations, logit_scale =
        log(1 / temperature)."""
        dense = [self.vit_proj, self.ast_proj]
        if self.detr_heads:
            dense.append(self.class_embed)
            if self.cfg.loss.contrastive_align_loss:
                dense += [self.contrastive_align_projection_query,
                          self.contrastive_align_projection_vid]
        for lin in dense:
            L.lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        for trm in {id(t): t for t in (self.temporal("video"), self.temporal("music"))
                    if t is not None}.values():
            trm.reset_parameters(generator)
        for which in ("video", "audio"):
            if hasattr(self, f"{which}_embedding_net"):
                getattr(self, f"{which}_embedding_net").reset_parameters(generator)
            if hasattr(self, f"{which}_cls_token"):      # flax truncated_normal(0.02)
                nn.init.trunc_normal_(getattr(self, f"{which}_cls_token"), 0.0, 0.02, -0.04,
                                      0.04, generator=generator)
        for name in ("video_guided_to_music_pooling_cross_transformer",
                     "music_guided_to_video_pooling_cross_transformer"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters()
        for name in ("video_music_fusion_cross_transformer", "span_embed", "moment_embed",
                     "reg_mlp"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(generator)
        self.detr_transformer.reset_parameters(generator)
        self.decoder_query_embed.weight.normal_(generator=generator)
        self.logit_scale.fill_(math.log(1.0 / self.cfg.model.temperature_init_value))

    def temporal(self, which: str) -> Optional[TemporalTransformer]:
        """The temporal stack of the "video" or "music" tower: the shared
        one under transformer_is_share; None where agg_module is not
        "transf" or the depth is 0."""
        if self.cfg.model.transformer_is_share:
            return getattr(self, "share_transformer", None)
        return getattr(self, "video_transformer" if which == "video" else "audio_transformer",
                       None)

    def video_tower(self, feats: torch.Tensor, mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None, plain_temporal: bool = False):
        return tower(self.vit_proj, self.temporal("video"), self.video_pe, feats,
                     mask, self.cfg.model.with_act_after_proj, generator, plain_temporal,
                     getattr(self, "video_cls_token", None),
                     getattr(self, "video_embedding_net", None))

    def music_tower(self, feats: torch.Tensor, mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None, plain_temporal: bool = False):
        return tower(self.ast_proj, self.temporal("music"), self.audio_pe, feats,
                     mask, self.cfg.model.with_act_after_proj, generator, plain_temporal,
                     getattr(self, "audio_cls_token", None),
                     getattr(self, "audio_embedding_net", None))

    def forward(self, frame_feats: torch.Tensor, frame_mask: torch.Tensor,
                segment_feats: torch.Tensor, segment_mask: torch.Tensor,
                v_duration: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fused_decoder: bool = False) -> Dict[str, Any]:
        """The training forward (JAX made.py:112-311).

        frame_feats [B, F, vit_dim], segment_feats [B, S, ast_dim], masks
        [B, *] (1 = valid).  Dropout at the configured rates only with a
        `generator` (on the inputs' device); the kernels draw one Philox
        seed per call from it.  Returns the JAX model's keys: video_emb,
        music_emb, frame/seg tokens and masks, logit_scale, with X-Pool
        single_sim [V, M] (fused path) or music_pooled [M, V, D] and
        video_pooled [V, M, D] (XA-video, XA-music-video), memory,
        pred_logits_layers and pred_spans_layers ([layers, B, Q, 2]; [1, B,
        1, 2] in regression, its logits zero) and, with the DETR heads, the
        contrastive-align loss's proj_queries_layers and proj_vid_mem and
        moment_loss's moment_feats [B, Q, D].  The CA fusion and the
        music-guided X-Pool run in float32 whatever the compute dtype, as
        JAX's.

        fused_decoder: the DETR decoder's layers on the decoder-layer kernel
        (float32 whatever the compute dtype; post-norm only).  That layer
        has no dropout, so a training call (a generator) with detr_dropout
        > 0 raises rather than train another model."""
        m = self.cfg.model
        d = m.dim_input
        if fused_decoder and generator is not None and m.detr_dropout > 0.0:
            raise ValueError(
                f"fused_decoder=True has no dropout, but model.detr_dropout="
                f"{m.detr_dropout} in a training call: set detr_dropout=0.0 or run "
                "the plain decoder")
        frame_tokens, video_emb, frame_mask = self.video_tower(frame_feats, frame_mask,
                                                               generator)
        seg_tokens, music_emb, segment_mask = self.music_tower(segment_feats, segment_mask,
                                                               generator)
        out: Dict[str, Any] = {
            "frame_tokens": frame_tokens, "video_emb": video_emb,
            "seg_tokens": seg_tokens, "music_emb": music_emb,
            "frame_mask": frame_mask, "segment_mask": segment_mask,
            "logit_scale": self.logit_scale,
        }
        seg_mask = segment_mask if m.fusion_mask else None
        if self.use_fused_sim:
            rate = m.xpool_dropout if generator is not None else 0.0
            seed = L.draw_seed(generator) if rate > 0.0 else 0
            mask = seg_mask if seg_mask is not None else torch.ones_like(segment_mask)
            out["single_sim"] = self.xpool.pooled_similarity(video_emb, seg_tokens, mask,
                                                             rate, seed)
        elif self.xpool is not None:
            out["music_pooled"] = self.xpool(video_emb, seg_tokens, seg_mask, generator)
        if hasattr(self, "music_guided_to_video_pooling_cross_transformer"):
            out["video_pooled"] = self.music_guided_to_video_pooling_cross_transformer(
                music_emb, frame_tokens, frame_mask if m.fusion_mask else None, generator)

        if m.mml_fusion == "CA":
            # snippets query frames; the fused sequence is the snippets'
            fused, _ = self.video_music_fusion_cross_transformer(
                seg_tokens, frame_tokens, q_mask=segment_mask, kv_mask=frame_mask,
                generator=generator)
            fused = fused * (segment_mask[..., None] != 0).to(fused.dtype)
            fused_mask = segment_mask
        else:
            fused = torch.cat([frame_tokens, seg_tokens], dim=1)
            fused_mask = torch.cat([frame_mask, segment_mask], dim=1)
        fused, fused_mask = L.pad_fused_sequence(fused, fused_mask, m.detr_seq_pad_multiple)
        pos = L.position_embedding_sine(fused_mask, d)
        nq = m.num_moment_queries
        if m.moment_query_type == "video":
            target = video_emb[:, None, :].expand(-1, nq, -1)
        elif m.moment_query_type == "music":
            target = music_emb[:, None, :].expand(-1, nq, -1)
        elif m.moment_query_type == "xpool":
            target = out["music_pooled"].mean(dim=1)[:, None, :].expand(-1, nq, -1)
        else:                                   # "zero" / "random": zeros
            target = None
        with torch.autocast(fused.device.type, dtype=self.compute_dtype or torch.bfloat16,
                            enabled=self.compute_dtype is not None):
            hidden, memory = self.detr_transformer(
                fused, fused_mask, pos, self.decoder_query_embed.weight, target,
                generator, plain=not m.fused_detr_encoder,
                precision="bf16" if self.compute_dtype == torch.bfloat16 else "f32",
                fused_decoder=fused_decoder)
        hidden = L.widen(hidden)
        memory = L.widen(memory)
        out["memory"] = memory

        if not self.detr_heads:
            # regression: the masked mean of the memory -> one span per row
            pooled = (memory * fused_mask[..., None]).sum(1) / fused_mask.sum(1, keepdim=True)
            coord = torch.sigmoid(self.reg_mlp(pooled))[:, None, :]        # [B, 1, 1 | 2]
            if m.predict_center:
                width = (v_duration / self.cfg.data.max_m_duration)[:, None, None]
                coord = torch.cat([coord, width.expand(*coord.shape[:-1], 1)], dim=-1)
            out["pred_spans_layers"] = coord[None]
            out["pred_logits_layers"] = coord.new_zeros(1, coord.shape[0], 1, 2)
            return out

        out["pred_logits_layers"] = self.class_embed(hidden)
        coord = torch.sigmoid(self.span_embed(hidden))
        if m.predict_center:
            width = (v_duration / self.cfg.data.max_m_duration)[None, :, None, None]
            coord = torch.cat([coord, width.expand(*coord.shape[:-1], 1)], dim=-1)
        out["pred_spans_layers"] = coord
        if self.cfg.loss.contrastive_align_loss:
            pq = L.l2_normalize(self.contrastive_align_projection_query(hidden))
            if m.audio_short_cut:
                pq = L.l2_normalize(pq + music_emb[None, :, None, :])
            out["proj_queries_layers"] = pq
            out["proj_vid_mem"] = L.l2_normalize(
                self.contrastive_align_projection_vid(frame_tokens))
        if m.moment_loss:
            mf = L.l2_normalize(self.moment_embed(hidden[-1]))
            if m.audio_short_cut:
                mf = L.l2_normalize(mf + music_emb[:, None, :])
            out["moment_feats"] = mf
        return out

    @property
    def xpool(self) -> Optional[XPoolTransformer]:
        """The video-guided music X-Pool (JAX's xpool_v2m), None where
        vmr_fusion builds none ("NO", "XA-video")."""
        return getattr(self, "video_guided_to_music_pooling_cross_transformer", None)
