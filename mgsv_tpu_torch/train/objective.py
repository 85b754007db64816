"""The dual-task training objective, ported from mgsv_tpu/train/objective.py.

loss = ret_loss_weight * retrieval + loc_loss_weight * localization: every
vmr_loss branch (the paper configuration's dual_single_loss_fuse among
them) and the DETR or regression localization, as in JAX.

Over a data-parallel mesh (core/mesh.py) the loss is the global batch's,
as JAX's SPMD program computes it.  The retrieval losses need every row
and every column of the [V, M] matrix: each rank gathers the similarity
rows of every rank (and the embeddings and music codes) and computes the
whole retrieval loss, which enters its objective divided by dp.  The
localization losses are per row: each rank's term is its rows' share of
the global mean, normalized by global counts.  The ranks' objectives so
add up to the global loss, and the sum of their gradients is its gradient
(core/mesh.py); the log holds the global values on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.mesh import Mesh, all_reduce_sum, gather_rows
from mgsv_tpu_torch.models.xpool import (sim_matrix_both_pooling, sim_matrix_music_pooling,
                                         sim_matrix_video_pooling)
from mgsv_tpu_torch.ops import losses as loss_ops


def retrieval_loss(outputs: Dict[str, Any], cfg: Config, music_codes=None,
                   mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict]:
    """music_codes: optional [B] track ids for the ignore_same_music=0
    InfoNCE branch.  mesh: the outputs are this rank's rows (MaDe.forward),
    the loss the global batch's, whole on every rank."""
    lc = cfg.loss
    if lc.ignore_same_music != 0:
        music_codes = None
    rows = (lambda t: t) if mesh is None else (lambda t: gather_rows(t, mesh))
    scale = outputs["logit_scale"]
    own_video = outputs["video_emb"]
    video, music = rows(own_video), rows(outputs["music_emb"])
    if music_codes is not None:
        music_codes = rows(music_codes)
    aux: Dict[str, torch.Tensor] = {}

    def music_pooled_sim():
        if "single_sim" in outputs:        # the X-Pool kernel ships [V, M] directly
            return rows(outputs["single_sim"])
        return rows(sim_matrix_music_pooling(own_video, outputs["music_pooled"]))

    if lc.vmr_loss == "dual":
        loss = loss_ops.clip_loss(loss_ops.cosine_sim_matrix(video, music),
                                  scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "single":
        # the pooled similarities of whichever X-Pools vmr_fusion built
        sim = video.new_zeros(video.shape[0], music.shape[0])
        if "music_pooled" in outputs or "single_sim" in outputs:
            sim = sim + music_pooled_sim()
        if "video_pooled" in outputs:
            sim = sim + rows(sim_matrix_video_pooling(outputs["video_pooled"], music))
        loss = loss_ops.clip_loss(sim, scale) * lc.dual_single_loss_weight
    elif lc.vmr_loss == "dual_single_oneloss":
        sim = rows(sim_matrix_both_pooling(outputs["video_pooled"], outputs["music_pooled"]))
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
        loss = loss_ops.clip_loss(rows(sim_matrix_music_pooling(own_video, fused)),
                                  scale) * lc.dual_single_loss_weight
    else:
        raise ValueError(f"unsupported vmr_loss: {lc.vmr_loss}")
    return loss, aux


def localization_loss(outputs: Dict[str, Any], spans_target: torch.Tensor,
                      cfg: Config, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict]:
    """DETR set criterion, or the regression's L1 x 20 (its giou, label and
    class-error logs zero, as in JAX); spans_target [B, T, 2] normalized
    (center, width).  mesh: this rank's share of the global batch's means
    (the log's class_error is global)."""
    if cfg.model.mml_localization == "detr":
        return loss_ops.set_criterion(
            outputs["pred_logits_layers"], outputs["pred_spans_layers"],
            outputs.get("proj_queries_layers"), outputs.get("proj_vid_mem"),
            spans_target, cfg.loss, mesh=mesh)
    diff = (outputs["pred_spans_layers"][-1] - spans_target).abs()
    l1 = diff.mean() if mesh is None or mesh.dp == 1 else diff.sum() / (diff.numel() * mesh.dp)
    zero = l1.new_zeros(())
    log = {"loss_span": l1, "loss_giou": zero, "loss_label": zero, "class_error": zero}
    return l1 * 20.0, log


def total_loss(outputs: Dict[str, Any], spans_target: torch.Tensor, cfg: Config,
               music_codes=None, mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the objective to differentiate, the log).  mesh: the objective is
    this rank's share, the ranks' shares add up to the global loss, and the
    log holds the global values (detached) on every rank."""
    lc = cfg.loss
    ret, ret_aux = retrieval_loss(outputs, cfg, music_codes=music_codes, mesh=mesh)
    loc, loc_log = localization_loss(outputs, spans_target, cfg, mesh=mesh)
    if mesh is None:
        total = ret * lc.ret_loss_weight + loc * lc.loc_loss_weight
        log = {"loss": total, "retrieval_loss": ret, "localization_loss": loc}
        log.update(ret_aux)
        log.update(loc_log)
        return total, log
    # every rank holds the whole retrieval loss: each takes 1/dp of it
    objective = ret * (lc.ret_loss_weight / mesh.dp) + loc * lc.loc_loss_weight
    # the localization terms are shares: their sums over the ranks, in one
    # all-reduce (class_error is global already)
    shares = ["localization_loss"] + [k for k in loc_log if not k.startswith("class_error")]
    summed = all_reduce_sum(torch.stack([loc.detach()] + [loc_log[k].detach().reshape(())
                                                          for k in shares[1:]]), mesh)
    log = {"retrieval_loss": ret.detach()}
    log.update({k: v.detach() for k, v in ret_aux.items()})
    log.update({k: v.detach() for k, v in loc_log.items()})
    log.update(zip(shares, summed.unbind()))
    log["loss"] = log["retrieval_loss"] * lc.ret_loss_weight + log["localization_loss"] * \
        lc.loc_loss_weight
    return objective, {"loss": log.pop("loss"), **log}
