"""X-Pool cross-attention, ported from mgsv_tpu/models/xpool.py.

Every video embedding queries every music track's snippet sequence with one
head, giving one pooled music embedding per (music, video) pair:

    q = q_proj(LN1(video))            [V, D]
    k, v = k/v_proj(LN1(music_segs))  [M, S, D]
    ctx[m, v] = out_proj(softmax_s(q[v] . k[m, s] / sqrt(D), mask) v[m, s])
    out = LN3(LN2(ctx) + linear_proj(LN2(ctx)))     # no residual around attention

All projections start as the identity with zero bias, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mgsv_tpu_torch.models.layers import BIG_NEG, l2_normalize


class XPoolAttention(nn.Module):
    """The pooled single-head cross-attention core."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, video: torch.Tensor, music_segs: torch.Tensor,
                seg_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """video [V, D], music_segs [M, S, D], seg_mask [M, S] | None -> [M, V, D]."""
        q = self.q_proj(video)
        k = self.k_proj(music_segs)
        v = self.v_proj(music_segs)
        logits = torch.einsum("vd,msd->mvs", q, k) / math.sqrt(self.dim)
        if seg_mask is not None:
            logits = torch.where(seg_mask[:, None, :] != 0, logits,
                                 torch.full_like(logits, BIG_NEG))
        attn = torch.softmax(logits, dim=-1)
        return self.out_proj(torch.einsum("mvs,msd->mvd", attn, v))


class XPoolTransformer(nn.Module):
    """Transformer_XA: LN1 shared by video and snippets, no residual around
    the attention."""

    def __init__(self, dim: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = XPoolAttention(dim)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.linear_proj = nn.Linear(dim, dim)
        self.layer_norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """Identity projections with zero bias, unit LayerNorms."""
        ca = self.cross_attn
        for lin in (ca.q_proj, ca.k_proj, ca.v_proj, ca.out_proj, self.linear_proj):
            lin.weight.copy_(torch.eye(lin.weight.shape[0]))
            lin.bias.zero_()
        for ln in (self.layer_norm1, self.layer_norm2, self.layer_norm3):
            ln.reset_parameters()

    def forward(self, video: torch.Tensor, music_segs: torch.Tensor,
                seg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> pooled [M, V, D]."""
        attn_out = self.layer_norm2(self.cross_attn(
            self.layer_norm1(video), self.layer_norm1(music_segs), seg_mask))
        return self.layer_norm3(attn_out + self.linear_proj(attn_out))


def sim_matrix_music_pooling(video: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """video [V, D], pooled [M, V, D] -> [V, M]:
    sims[v, m] = <video_hat[v], pooled_hat[m, v]>."""
    return torch.einsum("vd,mvd->vm", l2_normalize(video), l2_normalize(pooled))
