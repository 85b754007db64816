"""The dual-task training objective, ported from mgsv_tpu/train/objective.py.

loss = ret_loss_weight * retrieval + loc_loss_weight * localization.  The
port has the retrieval branches its `MaDe` can produce (the paper
configuration's dual_single_loss_fuse among them) and DETR localization;
the other variants raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models.xpool import sim_matrix_music_pooling
from mgsv_tpu_torch.ops import losses as loss_ops

_NOT_PORTED = "(ROADMAP.md, queue 1: variant matrix)"


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
        loss = loss_ops.clip_loss(music_pooled_sim(), scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "dual_single_loss_fuse":
        dual = loss_ops.info_nce_loss(loss_ops.cosine_sim_matrix(video, music), scale,
                                      music_codes)
        single = loss_ops.clip_loss(music_pooled_sim(), scale)
        loss = dual * 1.0 + single * 1.0
        aux["dual_loss"], aux["single_loss"] = dual, single
    elif lc.vmr_loss == "dual_single_sim_fuse":
        loss = loss_ops.clip_loss(loss_ops.cosine_sim_matrix(video, music) + music_pooled_sim(),
                                  scale) * lc.dual_single_loss_weight
    else:
        raise NotImplementedError(f"vmr_loss={lc.vmr_loss!r} is not ported yet {_NOT_PORTED}")
    return loss, aux


def localization_loss(outputs: Dict[str, Any], spans_target: torch.Tensor,
                      cfg: Config) -> Tuple[torch.Tensor, Dict]:
    """DETR set criterion; spans_target [B, T, 2] normalized (center, width)."""
    if cfg.model.mml_localization != "detr":
        raise NotImplementedError(
            f"mml_localization={cfg.model.mml_localization!r} is not ported yet {_NOT_PORTED}")
    return loss_ops.set_criterion(
        outputs["pred_logits_layers"], outputs["pred_spans_layers"],
        outputs.get("proj_queries_layers"), outputs.get("proj_vid_mem"),
        spans_target, cfg.loss)


def total_loss(outputs: Dict[str, Any], spans_target: torch.Tensor, cfg: Config,
               music_codes=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ret, ret_aux = retrieval_loss(outputs, cfg, music_codes=music_codes)
    loc, loc_log = localization_loss(outputs, spans_target, cfg)
    total = ret * cfg.loss.ret_loss_weight + loc * cfg.loss.loc_loss_weight
    log = {"loss": total, "retrieval_loss": ret, "localization_loss": loc}
    log.update(ret_aux)
    log.update(loc_log)
    return total, log
