"""The dual-task training objective, ported from mgsv_tpu/train/objective.py.

loss = ret_loss_weight * retrieval + loc_loss_weight * localization: every
vmr_loss branch (the paper configuration's dual_single_loss_fuse among
them) and the DETR or regression localization, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models.xpool import (sim_matrix_both_pooling, sim_matrix_music_pooling,
                                         sim_matrix_video_pooling)
from mgsv_tpu_torch.ops import losses as loss_ops


def retrieval_loss(outputs: Dict[str, Any], cfg: Config,
                   music_codes=None) -> Tuple[torch.Tensor, Dict]:
    """music_codes: optional [B] track ids for the ignore_same_music=0
    InfoNCE branch."""
    lc = cfg.loss
    if lc.ignore_same_music != 0:
        music_codes = None
    scale = outputs["logit_scale"]
    video, music = outputs["video_emb"], outputs["music_emb"]
    aux: Dict[str, torch.Tensor] = {}

    def music_pooled_sim():
        if "single_sim" in outputs:        # the X-Pool kernel ships [V, M] directly
            return outputs["single_sim"]
        return sim_matrix_music_pooling(video, outputs["music_pooled"])

    if lc.vmr_loss == "dual":
        loss = loss_ops.clip_loss(loss_ops.cosine_sim_matrix(video, music),
                                  scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "single":
        # the pooled similarities of whichever X-Pools vmr_fusion built
        sim = video.new_zeros(video.shape[0], music.shape[0])
        if "music_pooled" in outputs or "single_sim" in outputs:
            sim = sim + music_pooled_sim()
        if "video_pooled" in outputs:
            sim = sim + sim_matrix_video_pooling(outputs["video_pooled"], music)
        loss = loss_ops.clip_loss(sim, scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "dual_single_oneloss":
        sim = sim_matrix_both_pooling(outputs["video_pooled"], outputs["music_pooled"])
        loss = loss_ops.clip_loss(sim, scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "dual_single_loss_fuse":
        dual = loss_ops.info_nce_loss(loss_ops.cosine_sim_matrix(video, music), scale,
                                      music_codes)
        single = loss_ops.clip_loss(music_pooled_sim(), scale)
        loss = dual * 1.0 + single * 1.0
        aux["dual_loss"], aux["single_loss"] = dual, single
    elif lc.vmr_loss == "dual_single_sim_fuse":
        loss = loss_ops.clip_loss(loss_ops.cosine_sim_matrix(video, music) + music_pooled_sim(),
                                  scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "dual_single_feature_fuse":
        fused = (outputs["music_pooled"] + music[:, None, :]) * 0.5
        loss = loss_ops.clip_loss(sim_matrix_music_pooling(video, fused),
                                  scale) * lc.dual_single_loss_weight
    else:
        raise ValueError(f"unsupported vmr_loss: {lc.vmr_loss}")
    return loss, aux


def localization_loss(outputs: Dict[str, Any], spans_target: torch.Tensor,
                      cfg: Config) -> Tuple[torch.Tensor, Dict]:
    """DETR set criterion, or the regression's L1 x 20 (its giou, label and
    class-error logs zero, as in JAX); spans_target [B, T, 2] normalized
    (center, width)."""
    if cfg.model.mml_localization == "detr":
        return loss_ops.set_criterion(
            outputs["pred_logits_layers"], outputs["pred_spans_layers"],
            outputs.get("proj_queries_layers"), outputs.get("proj_vid_mem"),
            spans_target, cfg.loss)
    l1 = (outputs["pred_spans_layers"][-1] - spans_target).abs().mean()
    zero = l1.new_zeros(())
    log = {"loss_span": l1, "loss_giou": zero, "loss_label": zero, "class_error": zero}
    return l1 * 20.0, log


def total_loss(outputs: Dict[str, Any], spans_target: torch.Tensor, cfg: Config,
               music_codes=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ret, ret_aux = retrieval_loss(outputs, cfg, music_codes=music_codes)
    loc, loc_log = localization_loss(outputs, spans_target, cfg)
    total = ret * cfg.loss.ret_loss_weight + loc * cfg.loss.loc_loss_weight
    log = {"loss": total, "retrieval_loss": ret, "localization_loss": loc}
    log.update(ret_aux)
    log.update(loc_log)
    return total, log
