"""X-Pool cross-attention, ported from mgsv_tpu/models/xpool.py.

Every video embedding queries every music track's snippet sequence with one
head, giving one pooled music embedding per (music, video) pair:

    q = q_proj(LN1(video))            [V, D]
    k, v = k/v_proj(LN1(music_segs))  [M, S, D]
    ctx[m, v] = out_proj(softmax_s(q[v] . k[m, s] / sqrt(D), mask) v[m, s])
    out = LN3(LN2(ctx) + dropout(linear_proj(LN2(ctx))))   # no residual around attention

All projections start as the identity with zero bias, as in the reference.
`pooled_similarity` is the training path's twin of the JAX `FusedXPoolSim`:
it goes straight to the [V, M] pooled cosine similarity through the X-Pool
kernel (ops/cuda/xpool_sim.py), so the [M, V, D] pooled tensor never exists.
The same module with music embeddings as its queries and frame tokens as
its keys is the music-guided video pooling of `vmr_fusion` XA-video and
XA-music-video ([V, M, D]); the `sim_matrix_*` functions are the
similarities the retrieval losses take from the pooled tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mgsv_tpu_torch.models.layers import BIG_NEG, dropout, l2_normalize
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps


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
    the attention; dropout `dropout` (0.3 in the paper configuration) on the
    linear branch."""

    def __init__(self, dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
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
                seg_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> pooled [M, V, D]; dropout only with a generator."""
        attn_out = self.layer_norm2(self.cross_attn(
            self.layer_norm1(video), self.layer_norm1(music_segs), seg_mask))
        lin = dropout(self.linear_proj(attn_out), self.dropout, generator)
        return self.layer_norm3(attn_out + lin)

    def stage_weights(self) -> Tuple[torch.Tensor, ...]:
        """The per-pair stage's tensors in the kernel's order: Wout, bout,
        g2, b2, Wlin, blin, g3, b3 (torch layout)."""
        out, lin = self.cross_attn.out_proj, self.linear_proj
        return (out.weight, out.bias, self.layer_norm2.weight, self.layer_norm2.bias,
                lin.weight, lin.bias, self.layer_norm3.weight, self.layer_norm3.bias)

    def pooled_similarity(self, video: torch.Tensor, seg_tokens: torch.Tensor,
                          mask: torch.Tensor, rate: float = 0.0, seed: int = 0
                          ) -> torch.Tensor:
        """sim_matrix_music_pooling(video, self(video, seg_tokens, mask)) as
        [V, M], with the linear branch's dropout at `rate` from the Philox
        stream `seed`.  LN1, the q/k/v projections and the video norm run as
        PyTorch ops under autograd; the per-pair stage goes through
        ops/cuda/xpool_sim.py."""
        ln1, ca = self.layer_norm1, self.cross_attn
        segs = ln1(seg_tokens)
        q = ca.q_proj(ln1(video)).contiguous()
        k, v = ca.k_proj(segs).contiguous(), ca.v_proj(segs).contiguous()
        vhat = l2_normalize(video).contiguous()
        return xps.xpool_sim(q, k, v, mask.float().contiguous(), vhat, self.stage_weights(),
                             rate, seed).T


def sim_matrix_music_pooling(video: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """video [V, D], pooled [M, V, D] -> [V, M]:
    sims[v, m] = <video_hat[v], pooled_hat[m, v]>."""
    return torch.einsum("vd,mvd->vm", l2_normalize(video), l2_normalize(pooled))


def sim_matrix_video_pooling(video_pooled: torch.Tensor, music: torch.Tensor) -> torch.Tensor:
    """video_pooled [V, M, D] (music queries pooling frame tokens), music
    [M, D] -> [V, M]: sims[v, m] = <music_hat[m], video_pooled_hat[v, m]>."""
    return torch.einsum("md,vmd->vm", l2_normalize(music), l2_normalize(video_pooled))


def sim_matrix_both_pooling(video_pooled: torch.Tensor, music_pooled: torch.Tensor
                            ) -> torch.Tensor:
    """video_pooled [V, M, D], music_pooled [M, V, D] -> [V, M]: the
    reference's bmm over the middle axis, then its mean,
    sims[v, m] = mean_k <video_pooled_hat[v, k], music_pooled_hat[m, v]>."""
    sims = torch.einsum("vkd,mvd->vkm", l2_normalize(video_pooled), l2_normalize(music_pooled))
    return sims.mean(dim=1)
