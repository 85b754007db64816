"""Retrieval similarities, ported from mgsv_tpu/eval/similarity.py,
mgsv_tpu/ops/pallas/xpool_sim.py::xpool_sim_fused and
mgsv_tpu/ops/losses.py::cosine_sim_matrix.

Over a (dp, mp) mesh (core/mesh.py), where every rank holds the whole
inputs and gets the whole [V, M] similarity:
- `xpool_similarity_sharded`: the plain blocked path with the tracks split
  over one axis (JAX :94-129);
- `xpool_similarity_sharded_2d`: the videos split over dp and the tracks
  over mp, each rank one [V/dp, M/mp] block (JAX :132-170);
- `xpool_similarity_mesh`: pads V and M and routes to one of the two, as
  JAX's (:173-226);
- `xpool_sim_fused_sharded`: the evaluation kernel with the tracks split
  over dp, as JAX's shard_map of it (:229-262).
Each rank computes its block alone, since the work is per (video, track)
pair, and the blocks are all-gathered over the axis groups; every rank's
block has one shape (all_gather needs equal sizes), so the inputs are
padded before they are split."""

from __future__ import annotations

from typing import Optional

import torch

from mgsv_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, gather_rows
from mgsv_tpu_torch.models.layers import l2_normalize
from mgsv_tpu_torch.models.xpool import XPoolTransformer, sim_matrix_music_pooling
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps


def dual_similarity(video_embs: torch.Tensor, music_embs: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the global embeddings: [V, D] x [M, D] -> [V, M]."""
    return l2_normalize(video_embs) @ l2_normalize(music_embs).T


def pad_tracks(seg_tokens: torch.Tensor, seg_mask: Optional[torch.Tensor], multiple: int
               ) -> tuple:
    """(tokens, mask) with the track count padded to a multiple of
    `multiple` by tracks of one valid zero snippet (a finite softmax); a
    mask of None becomes all ones."""
    m, s, d = seg_tokens.shape
    if seg_mask is None:
        seg_mask = torch.ones(m, s, device=seg_tokens.device)
    pad = (-m) % multiple
    if pad:
        seg_tokens = torch.cat([seg_tokens, seg_tokens.new_zeros(pad, s, d)])
        pad_mask = seg_mask.new_zeros(pad, s)
        pad_mask[:, 0] = 1
        seg_mask = torch.cat([seg_mask, pad_mask])
    return seg_tokens, seg_mask


def gather_columns(block: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[R, C] on each rank of an `axis` group -> [R, n * C], the group's
    blocks side by side in axis order, on every rank of it."""
    return gather_rows(block.T.contiguous(), mesh, axis).T


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
    """`xpool_sim_fused` with the tracks split over the mesh's dp axis: the
    track count is padded to a multiple of dp (`pad_tracks`), each rank runs
    the evaluation kernel on its dp index's block of tracks against every
    video, and the [tracks, V] blocks are all-gathered over the dp group;
    the pad columns are dropped, so they never rank.  The mp replicas of a
    dp index compute the same block, as JAX's shard_map with P("dp")
    (mgsv_tpu/eval/similarity.py:229-262).  Returns [V, M] on every rank."""
    m = seg_tokens.shape[0]
    seg_tokens, seg_mask = pad_tracks(seg_tokens, seg_mask, mesh.dp)
    per = seg_tokens.shape[0] // mesh.dp
    own = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    sims = xps.xpool_sim_eval(*xpool_eval_inputs(video_embs, seg_tokens[own], seg_mask[own],
                                                 xpool))              # [per, V]
    return gather_rows(sims.contiguous(), mesh)[:m].T.contiguous()


def xpool_similarity_sharded(
    xpool: XPoolTransformer,
    video_embs: torch.Tensor,              # [V, D], every rank's whole
    seg_tokens: torch.Tensor,              # [M, S, D], every rank's whole
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    mesh: Mesh,
    axis: str = DATA_AXIS,
    block_size: int = 256,
) -> torch.Tensor:
    """The blocked plain similarity with the tracks split over `axis`: each
    rank of the axis group runs `xpool_similarity_blocked` on its block of
    M / n tracks against every video, and the [V, M / n] blocks are
    all-gathered over the group; mgsv_tpu/eval/similarity.py:94-129.  M
    must divide by the axis size.  Returns [V, M] on every rank."""
    n, m = mesh.shape[axis], seg_tokens.shape[0]
    if m % n:
        raise ValueError(f"music count {m} not divisible by mesh axis {axis}={n}")
    per = m // n
    own = slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)
    block = xpool_similarity_blocked(xpool, video_embs, seg_tokens[own],
                                     None if seg_mask is None else seg_mask[own],
                                     block_size=min(block_size, per))
    return gather_columns(block, mesh, axis)


def xpool_similarity_sharded_2d(
    xpool: XPoolTransformer,
    video_embs: torch.Tensor,              # [V, D], every rank's whole
    seg_tokens: torch.Tensor,              # [M, S, D], every rank's whole
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    mesh: Mesh,
    video_axis: str = DATA_AXIS,
    music_axis: str = MODEL_AXIS,
    block_size: int = 256,
) -> torch.Tensor:
    """The blocked plain similarity over the whole mesh: rank (i, j)
    computes the [V / dp, M / mp] block of video block i and track block j
    (no collective, the work being per pair), and the blocks are gathered
    over the music axis's group, then over the video axis's, to the whole
    [V, M] on every rank; mgsv_tpu/eval/similarity.py:132-170.  V must
    divide by the video axis and M by the music axis."""
    nv, nm = mesh.shape[video_axis], mesh.shape[music_axis]
    v, m = video_embs.shape[0], seg_tokens.shape[0]
    if v % nv or m % nm:
        raise ValueError(f"[{v}, {m}] does not split over {video_axis}={nv} x "
                         f"{music_axis}={nm}")
    pv, pm = v // nv, m // nm
    vi, mi = mesh.index(video_axis), mesh.index(music_axis)
    tracks = slice(mi * pm, (mi + 1) * pm)
    block = xpool_similarity_blocked(xpool, video_embs[vi * pv:(vi + 1) * pv],
                                     seg_tokens[tracks],
                                     None if seg_mask is None else seg_mask[tracks],
                                     block_size=min(block_size, pm))
    return gather_rows(gather_columns(block, mesh, music_axis).contiguous(), mesh, video_axis)


def xpool_similarity_mesh(
    xpool: XPoolTransformer,
    video_embs: torch.Tensor,              # [V, D], every rank's whole
    seg_tokens: torch.Tensor,              # [M, S, D], every rank's whole
    seg_mask: Optional[torch.Tensor],      # [M, S] or None
    mesh: Mesh,
    block_size: int = 256,
) -> torch.Tensor:
    """The corpus similarity over a mesh, any V and M; JAX's
    (mgsv_tpu/eval/similarity.py:173-226).  M is padded to a multiple of
    mp, or of dp where mp = 1 (`pad_tracks`; a mask of None becomes all
    ones, as JAX's evaluator passes at fusion_mask False,
    mgsv_tpu/eval/evaluator.py:266-267); at mp > 1 V is padded to a
    multiple of dp with rows of ones (a zero video embedding would 0/0 to
    NaN in its own row) and the 2-D path runs, else the tracks split over
    dp.  Returns exactly [V, M] on every rank."""
    dp, mp = mesh.dp, mesh.mp
    v, m = video_embs.shape[0], seg_tokens.shape[0]
    seg_tokens, seg_mask = pad_tracks(seg_tokens, seg_mask, mp if mp > 1 else dp)
    if mp > 1:
        pad_v = (-v) % dp
        if pad_v:
            video_embs = torch.cat([video_embs, video_embs.new_ones(pad_v, video_embs.shape[1])])
        sim = xpool_similarity_sharded_2d(xpool, video_embs, seg_tokens, seg_mask, mesh,
                                          block_size=block_size)
        return sim[:v, :m].contiguous()
    sim = xpool_similarity_sharded(xpool, video_embs, seg_tokens, seg_mask, mesh,
                                   block_size=min(block_size, seg_tokens.shape[0] // dp))
    return sim[:, :m].contiguous()
