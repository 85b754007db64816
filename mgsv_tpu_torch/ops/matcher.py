"""DETR-style matcher, ported from mgsv_tpu/ops/matcher.py.

cost = cost_span * L1(cw) + cost_giou * (-gIoU(se)) + cost_class * (-P[fg]),
targets filtered by width != 0, padded to a static count with a validity
mask.  One moment query (the paper configuration) takes the two fast
paths; more queries take the exact batched LSAP solver (ops/lsap.py) on
the cost's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgsv_tpu_torch.config import LossConfig
from mgsv_tpu_torch.ops import lsap
from mgsv_tpu_torch.ops.spans import generalized_temporal_iou, span_cw_to_se

_PAD_COST = 1e6


class MatchResult(NamedTuple):
    """tgt_to_pred [B, T] int64: the prediction matched to each target slot
    (meaningless where invalid); pair_valid [B, T] bool."""

    tgt_to_pred: torch.Tensor
    pair_valid: torch.Tensor


def matcher_cost(pred_logits: torch.Tensor, pred_spans_cw: torch.Tensor,
                 tgt_spans_cw: torch.Tensor, tgt_mask: torch.Tensor,
                 cfg: LossConfig) -> torch.Tensor:
    """Pairwise cost [B, Q, T]; invalid targets cost _PAD_COST."""
    prob_fg = torch.softmax(pred_logits, dim=-1)[..., cfg.foreground_label]
    cost_class = -prob_fg[..., None]
    cost_span = (pred_spans_cw[:, :, None, :] - tgt_spans_cw[:, None, :, :]).abs().sum(-1)
    pred_se, tgt_se = span_cw_to_se(pred_spans_cw), span_cw_to_se(tgt_spans_cw)
    cost_giou = -generalized_temporal_iou(pred_se, tgt_se)
    cost = cfg.cost_span * cost_span + cfg.cost_giou * cost_giou + cfg.cost_class * cost_class
    return torch.where(tgt_mask[:, None, :], cost, torch.full_like(cost, _PAD_COST))


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_spans_cw: torch.Tensor,
                    tgt_spans_cw: torch.Tensor, tgt_mask: torch.Tensor,
                    cfg: LossConfig) -> MatchResult:
    """Optimal 1-1 assignment of predictions to valid targets (no gradient
    flows through an assignment)."""
    num_queries, num_targets = pred_spans_cw.shape[1], tgt_spans_cw.shape[1]
    b = pred_spans_cw.shape[0]
    tgt_mask = tgt_mask.bool()
    if num_queries == 1 and num_targets == 1:
        return MatchResult(torch.zeros(b, 1, dtype=torch.int64, device=tgt_mask.device),
                           tgt_mask)
    cost = matcher_cost(pred_logits, pred_spans_cw, tgt_spans_cw, tgt_mask, cfg)
    if num_queries == 1:
        # one prediction: it matches the single cheapest valid target
        best = cost[:, 0, :].argmin(dim=-1)
        one_hot = torch.nn.functional.one_hot(best, num_targets).bool()
        return MatchResult(torch.zeros(b, num_targets, dtype=torch.int64,
                                       device=tgt_mask.device), one_hot & tgt_mask)
    col_to_row = lsap.solve_batch(cost)                             # [B, T]
    return MatchResult(col_to_row.clamp(0, num_queries - 1),
                       (col_to_row < num_queries) & tgt_mask)
