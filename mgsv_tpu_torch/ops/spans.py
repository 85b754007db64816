"""Span math, ported from mgsv_tpu/ops/spans.py: (center, width) <->
(start, end), pairwise and elementwise temporal IoU / gIoU, and the
top-1 evaluation IoU with the reference's clamping rules."""

from __future__ import annotations

import torch


def span_cw_to_se(cw: torch.Tensor) -> torch.Tensor:
    """[..., 2] (center, width) -> (start, end)."""
    center, width = cw[..., 0], cw[..., 1]
    return torch.stack([center - 0.5 * width, center + 0.5 * width], dim=-1)


def span_se_to_cw(se: torch.Tensor) -> torch.Tensor:
    """[..., 2] (start, end) -> (center, width)."""
    start, end = se[..., 0], se[..., 1]
    return torch.stack([(start + end) * 0.5, end - start], dim=-1)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where den <= 0 (in value and in gradient)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor):
    """Pairwise IoU of (start, end) spans [..., N, 2] x [..., M, 2] ->
    (iou, union) [..., N, M] (leading dimensions batch)."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = torch.clamp(right - left, min=0)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    return _safe_div(inter, union), union


def generalized_temporal_iou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """Pairwise 1-D generalized IoU of (start, end) spans -> [..., N, M]."""
    iou, union = temporal_iou(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclosing = torch.clamp(right - left, min=0)
    return iou - _safe_div(enclosing - union, enclosing)


def elementwise_temporal_giou(spans1: torch.Tensor, spans2: torch.Tensor) -> torch.Tensor:
    """gIoU of matched pairs: [..., 2] x [..., 2] -> [...]."""
    inter_l = torch.maximum(spans1[..., 0], spans2[..., 0])
    inter_r = torch.minimum(spans1[..., 1], spans2[..., 1])
    inter = torch.clamp(inter_r - inter_l, min=0)
    union = (spans1[..., 1] - spans1[..., 0]) + (spans2[..., 1] - spans2[..., 0]) - inter
    iou = _safe_div(inter, union)
    enc_l = torch.minimum(spans1[..., 0], spans2[..., 0])
    enc_r = torch.maximum(spans1[..., 1], spans2[..., 1])
    enclosing = torch.clamp(enc_r - enc_l, min=0)
    return iou - _safe_div(enclosing - union, enclosing)


def individual_iou(gt_st, gt_ed, m_duration, pred_st, pred_ed) -> torch.Tensor:
    """Eval IoU with the reference's clamps: pred_st >= 0, pred_ed <=
    m_duration, 0 where gt_st >= gt_ed or the union is empty."""
    pred_st = torch.clamp(pred_st, min=0)
    pred_ed = torch.minimum(pred_ed, m_duration)
    inter = torch.clamp(torch.minimum(gt_ed, pred_ed) - torch.maximum(gt_st, pred_st), min=0)
    union = (pred_ed - pred_st) + (gt_ed - gt_st) - inter
    iou = _safe_div(inter, union)
    return torch.where(gt_st >= gt_ed, torch.zeros_like(iou), iou)


def eval_iou_batch(gt_moments: torch.Tensor, m_durations: torch.Tensor,
                   pred_spans_sec: torch.Tensor, max_m_duration: float) -> torch.Tensor:
    """Top-1 prediction IoU per sample: gt_moments [B, 2] and pred_spans_sec
    [B, 2] (start, end) seconds, m_durations [B] -> [B]; predictions are
    clamped to [0, max_m_duration] first."""
    pred_st = torch.clamp(pred_spans_sec[..., 0], min=0)
    pred_ed = torch.clamp(pred_spans_sec[..., 1], max=max_m_duration)
    return individual_iou(gt_moments[..., 0], gt_moments[..., 1], m_durations,
                          pred_st, pred_ed)
