"""Retrieval similarities, ported from mgsv_tpu/eval/similarity.py and
mgsv_tpu/ops/losses.py::cosine_sim_matrix (single device)."""

from __future__ import annotations

from typing import Optional

import torch

from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.xpool import XPoolTransformer, sim_matrix_music_pooling


def dual_similarity(video_embs: torch.Tensor, music_embs: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the global embeddings: [V, D] x [M, D] -> [V, M]."""
    return l2_normalize(video_embs) @ l2_normalize(music_embs).T


def xpool_similarity_blocked(
    xpool: XPoolTransformer,
    video_embs: torch.Tensor,              # [V, D]
    seg_tokens: torch.Tensor,              # [M, S, D] (float32 or bfloat16)
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    block_size: int = 256,
) -> torch.Tensor:
    """[V, M] pooled X-Pool similarity, one block of tracks at a time, so the
    [M, V, D] pooled tensor never exists whole.  The last block is padded to
    the block size with tracks that have one valid snippet (a finite
    softmax); their columns are dropped."""
    m, s, d = seg_tokens.shape
    out = torch.empty(video_embs.shape[0], m, device=video_embs.device)
    for start in range(0, m, block_size):
        toks = seg_tokens[start:start + block_size].float()
        msk = None if seg_mask is None else seg_mask[start:start + block_size]
        n = toks.shape[0]
        if n < block_size:
            toks = torch.cat([toks, toks.new_zeros(block_size - n, s, d)])
            if msk is not None:
                pad = msk.new_zeros(block_size - n, s)
                pad[:, 0] = 1
                msk = torch.cat([msk, pad])
        pooled = xpool(video_embs, toks, msk)                 # [block, V, D]
        out[:, start:start + n] = sim_matrix_music_pooling(video_embs, pooled)[:, :n]
    return out
