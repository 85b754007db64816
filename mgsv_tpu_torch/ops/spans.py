"""Span format conversions, ported from mgsv_tpu/ops/spans.py."""

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
