"""Retrieval similarities, ported from mgsv_tpu/eval/similarity.py,
mgsv_tpu/ops/pallas/xpool_sim.py::xpool_sim_fused and
mgsv_tpu/ops/losses.py::cosine_sim_matrix.

`xpool_sim_fused_sharded` splits the evaluation kernel's tracks over the
ranks of a data-parallel mesh (core/mesh.py), as JAX's shard_map of it
(mgsv_tpu/eval/similarity.py:234-262).  The plain blocked sharded
similarity, which only the engine's mesh path uses, and the 2-D (dp x mp)
similarity are not ported and raise (ROADMAP.md queue 1)."""

from __future__ import annotations

from typing import Optional

import torch

from mgsv_tpu_torch.core.mesh import Mesh, gather_rows
from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.xpool import XPoolTransformer, sim_matrix_music_pooling
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps


def dual_similarity(video_embs: torch.Tensor, music_embs: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the global embeddings: [V, D] x [M, D] -> [V, M]."""
    return l2_normalize(video_embs) @ l2_normalize(music_embs).T


def xpool_similarity_blocked(
    xpool: XPoolTransformer,
    video_embs: torch.Tensor,              # [V, D]
    seg_tokens: torch.Tensor,              # [M, S, D] (float32 or bfloat16)
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    block_size: int = 256,
    music_embs: Optional[torch.Tensor] = None,    # [M, D]
) -> torch.Tensor:
    """[V, M] pooled X-Pool similarity, one block of tracks at a time, so the
    [M, V, D] pooled tensor never exists whole.  The last block is padded to
    the block size with tracks that have one valid snippet (a finite
    softmax); their columns are dropped.  With `music_embs` each track's
    embedding is added to its pooled features before the cosine (the
    evaluation of vmr_loss "dual_single_feature_fuse")."""
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
        if music_embs is not None:
            pooled = pooled[:n] + music_embs[start:start + n, None, :].float()
        out[:, start:start + n] = sim_matrix_music_pooling(video_embs, pooled)[:, :n]
    return out


@torch.no_grad()
def xpool_eval_inputs(video_embs: torch.Tensor, seg_tokens: torch.Tensor,
                      seg_mask: Optional[torch.Tensor], xpool: XPoolTransformer) -> tuple:
    """(q, k, v, mask, vhat, weights), the evaluation kernel's inputs: LN1,
    the q/k/v projections and the video norm, run once as plain ops (JAX's
    xpool_sim.py:96-104 computes them outside its kernel too).  The tokens
    are cast to float32 before LN1, as the serving engine's blocked scan
    does; JAX takes them in their own dtype, which is float32 too in every
    compute_dtype (the towers end in a float32 projection)."""
    ln1, ca = xpool.layer_norm1, xpool.cross_attn
    segs = ln1(seg_tokens.float())
    q = ca.q_proj(ln1(video_embs)).contiguous()
    k, v = ca.k_proj(segs).contiguous(), ca.v_proj(segs).contiguous()
    del segs
    vhat = l2_normalize(video_embs).contiguous()
    mask = (torch.ones(seg_tokens.shape[:2], device=seg_tokens.device) if seg_mask is None
            else seg_mask.float().contiguous())
    return q, k, v, mask, vhat, tuple(w.detach() for w in xpool.stage_weights())


def xpool_sim_fused(
    video_embs: torch.Tensor,              # [V, D]
    seg_tokens: torch.Tensor,              # [M, S, D] (float32 or bfloat16)
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    xpool: XPoolTransformer,
) -> torch.Tensor:
    """[V, M] pooled X-Pool similarity on the evaluation kernel
    (ops/cuda/xpool_sim.py::xpool_sim_eval; its plain version on CPU
    tensors), equal to `xpool_similarity_blocked`."""
    sims = xps.xpool_sim_eval(*xpool_eval_inputs(video_embs, seg_tokens, seg_mask, xpool))
    # [M, V] -> [V, M] in row-major order, as the rankings read it row by row
    return sims.T.contiguous()


def xpool_sim_fused_sharded(
    video_embs: torch.Tensor,              # [V, D], every rank's whole
    seg_tokens: torch.Tensor,              # [M, S, D], every rank's whole
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    xpool: XPoolTransformer,
    mesh: Mesh,
) -> torch.Tensor:
    """`xpool_sim_fused` with the tracks split over the mesh's ranks: the
    track count is padded to a multiple of dp with tracks of one valid
    zero snippet (a finite softmax), each rank runs the evaluation kernel
    on its block of tracks against every video, and the [tracks, V] blocks
    are all-gathered; the pad columns are dropped, so they never rank.
    Returns [V, M] on every rank."""
    m, s, d = seg_tokens.shape
    if seg_mask is None:
        seg_mask = torch.ones(m, s, device=seg_tokens.device)
    pad = (-m) % mesh.dp
    if pad:
        seg_tokens = torch.cat([seg_tokens, seg_tokens.new_zeros(pad, s, d)])
        pad_mask = seg_mask.new_zeros(pad, s)
        pad_mask[:, 0] = 1
        seg_mask = torch.cat([seg_mask, pad_mask])
    per = (m + pad) // mesh.dp
    own = slice(mesh.rank * per, (mesh.rank + 1) * per)
    sims = xps.xpool_sim_eval(*xpool_eval_inputs(video_embs, seg_tokens[own], seg_mask[own],
                                                 xpool))              # [per, V]
    return gather_rows(sims.contiguous(), mesh)[:m].T.contiguous()


def xpool_similarity_sharded(*args, **kwargs):
    """JAX's plain blocked similarity with the index sharded over the
    music axis (mgsv_tpu/eval/similarity.py:97-133), which only the
    engine's mesh path uses: not ported."""
    raise NotImplementedError("xpool_similarity_sharded serves the engine's mesh= path, "
                              "which is not ported yet (ROADMAP.md, queue 1: the engine's "
                              "mesh path)")


def xpool_similarity_mesh(*args, **kwargs):
    """JAX's 2-D (dp x mp) corpus similarity (xpool_similarity_sharded_2d,
    xpool_similarity_mesh, mgsv_tpu/eval/similarity.py:136-228): not
    ported."""
    raise NotImplementedError("the 2-D (dp x mp) corpus similarity is not ported yet "
                              "(ROADMAP.md, queue 1: the 2-D similarity)")


xpool_similarity_sharded_2d = xpool_similarity_mesh
