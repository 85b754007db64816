"""Retrieval and detection losses, ported from mgsv_tpu/ops/losses.py.

Retrieval: symmetric CLIP / InfoNCE losses over in-batch similarity
matrices.  Detection: the DETR set criterion (span L1 + 1-D gIoU +
eos-weighted class CE + contrastive-align NCE) with the assignment from
ops/matcher.py, over the final and the auxiliary decoder layers.

Over a data-parallel mesh (core/mesh.py) the set criterion is the global
batch's: each rank's losses are its rows' share of the global means, with
the matched-pair and matched-query counts summed over the ranks in one
all-reduce, so the ranks' terms add up to the one-process loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.config import LossConfig
from mgsv_tpu_torch.core.mesh import Mesh, all_reduce_sum
from mgsv_tpu_torch.ops.matcher import MatchResult, hungarian_match
from mgsv_tpu_torch.ops.spans import elementwise_temporal_giou, span_cw_to_se


def _diag_mean(logp: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(logp).mean()


def cosine_sim_matrix(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalized cosine similarity [Nx, D] x [Ny, D] -> [Nx, Ny]."""
    x = x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps * eps))
    y = y / torch.sqrt(torch.clamp((y * y).sum(-1, keepdim=True), min=eps * eps))
    return x @ y.T


def clip_loss(sims: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric diagonal log-softmax CE; logit_scale is the log-space
    parameter, exponentiated here."""
    logits = sims * torch.exp(logit_scale)
    t2v = -_diag_mean(F.log_softmax(logits, dim=1))
    v2t = -_diag_mean(F.log_softmax(logits, dim=0))
    return (t2v + v2t) / 2.0


def info_nce_loss(sims: torch.Tensor, logit_scale: torch.Tensor,
                  music_codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE with arange labels; with `music_codes` ([N] track
    ids) the video->audio direction drops off-diagonal columns of the same
    track from the negatives."""
    logits = sims * torch.exp(logit_scale)
    if music_codes is None:
        v2a = -_diag_mean(F.log_softmax(logits, dim=1))
    else:
        n = logits.shape[0]
        diag = torch.eye(n, dtype=torch.bool, device=logits.device)
        keep = diag | (music_codes[:, None] != music_codes[None, :])
        masked = torch.where(keep, logits, torch.full_like(logits, float("-inf")))
        v2a = -_diag_mean(F.log_softmax(masked, dim=1))
    a2v = -_diag_mean(F.log_softmax(logits, dim=0))
    return (v2a + a2v) / 2.0


def _query_matched(pred_logits: torch.Tensor, match: MatchResult) -> torch.Tensor:
    """[B, Q] bool: the queries the assignment gives a valid target."""
    query_matched = torch.zeros(pred_logits.shape[:2], device=pred_logits.device)
    return query_matched.scatter_reduce(
        1, match.tgt_to_pred, match.pair_valid.to(query_matched.dtype), reduce="amax") > 0


def _layer_counts(pred_logits: torch.Tensor, match: MatchResult, cfg: LossConfig
                  ) -> torch.Tensor:
    """[3]: this rank's matched pairs, matched queries and matched queries
    predicted foreground, the normalizers of `_layer_criterion`."""
    qm = _query_matched(pred_logits, match).to(pred_logits.dtype)
    pred_fg = (pred_logits.argmax(dim=-1) == cfg.foreground_label).to(pred_logits.dtype)
    return torch.stack([match.pair_valid.to(pred_logits.dtype).sum(), qm.sum(),
                        (pred_fg * qm).sum()]).detach()


def _layer_criterion(pred_logits, pred_spans, proj_queries, proj_vid_mem,
                     tgt_spans, match: MatchResult, cfg: LossConfig,
                     counts: Optional[torch.Tensor] = None, dp: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """One decoder layer: pred_logits / pred_spans [B, Q, 2], proj_queries
    [B, Q, Dc] | None, proj_vid_mem [B, F, Dc] | None, tgt_spans [B, T, 2],
    and the layer's assignment.  counts: the global batch's `_layer_counts`
    over dp ranks, which makes each loss this rank's share of the global
    mean; None: this batch alone."""
    w = match.pair_valid.to(pred_spans.dtype)                       # [B, T]
    n_pairs = torch.clamp(w.sum() if counts is None else counts[0], min=1.0)
    losses: Dict[str, torch.Tensor] = {}
    mean = (lambda t: t.mean()) if dp == 1 else (lambda t: t.sum() / (t.numel() * dp))

    idx = match.tgt_to_pred
    matched = torch.gather(pred_spans, 1, idx[..., None].expand(-1, -1, 2))   # [B, T, 2]
    l1 = (matched - tgt_spans).abs()
    losses["loss_span"] = (l1 * w[..., None]).sum() / (n_pairs * 2.0)
    giou = elementwise_temporal_giou(span_cw_to_se(matched), span_cw_to_se(tgt_spans))
    losses["loss_giou"] = ((1.0 - giou) * w).sum() / n_pairs

    # per-query CE, eos_coef-weighted background, plain mean over B * Q
    query_matched = _query_matched(pred_logits, match)
    target_classes = torch.where(query_matched, cfg.foreground_label, cfg.background_label)
    logp = F.log_softmax(pred_logits, dim=-1)
    nll = -torch.gather(logp, -1, target_classes[..., None])[..., 0]
    class_weight = torch.where(query_matched, 1.0, cfg.eos_coef)    # eos_coef on background
    losses["loss_label"] = mean(nll * class_weight)

    qm = query_matched.to(pred_logits.dtype)
    if counts is None:
        pred_fg = (pred_logits.argmax(dim=-1) == cfg.foreground_label).to(pred_logits.dtype)
        acc = (pred_fg * qm).sum() / torch.clamp(qm.sum(), min=1.0) * 100.0
    else:
        acc = counts[2] / torch.clamp(counts[1], min=1.0) * 100.0
    losses["class_error"] = (100.0 - acc).detach()

    if cfg.contrastive_align_loss and proj_queries is not None and proj_vid_mem is not None:
        # the reference sums over every frame token, padding included
        logits = torch.einsum("bqd,bfd->bq", proj_queries, proj_vid_mem) / cfg.align_temperature
        pos_term = (logits * qm).sum(dim=1)
        num_pos = torch.clamp(qm.sum(dim=1), min=1.0)
        neg_term = torch.logsumexp(logits, dim=1)
        losses["loss_contrastive_align"] = mean(-pos_term / num_pos + neg_term)
    return losses


def set_criterion(pred_logits_layers: torch.Tensor, pred_spans_layers: torch.Tensor,
                  proj_queries_layers: Optional[torch.Tensor],
                  proj_vid_mem: Optional[torch.Tensor], tgt_spans: torch.Tensor,
                  cfg: LossConfig, mesh: Optional[Mesh] = None):
    """SetCriterion over every decoder layer ([L, B, Q, *], final last),
    matching re-run per layer (the layers' assignments solved as one batch:
    each is independent of the others).  Returns (total, log) with the
    final layer's losses and, with aux_loss, `{name}_{i}` for the earlier
    layers.  mesh: the rows are this rank's, and each loss is their share
    of the global batch's (module docstring)."""
    tgt_mask = tgt_spans[..., 1] != 0
    num_layers, b = pred_logits_layers.shape[:2]
    layers_first = lambda t: t.reshape(num_layers * b, *t.shape[2:])
    tiled = lambda t: t.repeat(num_layers, *[1] * (t.dim() - 1))
    match = hungarian_match(layers_first(pred_logits_layers), layers_first(pred_spans_layers),
                            tiled(tgt_spans), tiled(tgt_mask), cfg)
    matches = [MatchResult(*(t[i * b:(i + 1) * b] for t in match)) for i in range(num_layers)]
    counts = [None] * num_layers
    if mesh is not None:
        counts = all_reduce_sum(torch.stack([
            _layer_counts(pred_logits_layers[i], matches[i], cfg)
            for i in range(num_layers)]), mesh).unbind()
    per_layer = [
        _layer_criterion(pred_logits_layers[i], pred_spans_layers[i],
                         None if proj_queries_layers is None else proj_queries_layers[i],
                         proj_vid_mem, tgt_spans, matches[i], cfg, counts[i],
                         1 if mesh is None else mesh.dp)
        for i in range(num_layers)]
    layer_losses = {name: torch.stack([d[name] for d in per_layer]) for name in per_layer[0]}

    weights = {"loss_span": cfg.weight_span if cfg.l1_loss else 0.0,
               "loss_giou": cfg.weight_giou,
               "loss_label": cfg.weight_label}
    if cfg.contrastive_align_loss and "loss_contrastive_align" in layer_losses:
        weights["loss_contrastive_align"] = cfg.weight_contrastive_align
    total = 0.0
    for name, weight in weights.items():
        vals = layer_losses[name]
        total = total + weight * (vals.sum() if cfg.aux_loss else vals[-1])

    log = {name: vals[-1] for name, vals in layer_losses.items()}
    if cfg.aux_loss and num_layers > 1:
        for name, vals in layer_losses.items():
            for i in range(num_layers - 1):
                log[f"{name}_{i}"] = vals[i]
    return total, log
