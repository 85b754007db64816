"""Serving: music index + retrieval/localization query engine, ported from
mgsv_tpu/serve/engine.py, on one device or with the index sharded over the
ranks of a mesh (`mesh=`, below).

A query runs the video tower, the dual + pooled X-Pool similarity against
the whole index, top-k, and DETR localization of every (query, candidate)
pair.  With `use_fused_kernels` (the default on a CUDA device) the DETR
encoder layers run on the hand-written CUDA kernel
(ops/cuda/fused_encoder_layer.py) in float32, as the JAX fused path does;
a config whose shapes the kernel does not take raises at the first query.
A pre-norm DETR (`detr_pre_norm`) never takes the kernel, as in JAX.
Otherwise the plain modules run in the configured compute dtype (the CPU
runs them either way).  The engine serves what JAX's serves: the
video-guided music X-Pool, concat fusion, the video moment query and the
DETR heads; a config without one of them raises ValueError (JAX's engine
fails on a missing X-Pool or head with a KeyError, and would run concat
fusion and the video query where the model was trained otherwise).  It
ranks by the dual similarity plus the pooled one, which is the evaluation's
ranking under vmr_loss dual_single_loss_fuse and dual_single_sim_fuse
only, so every other vmr_loss raises ValueError too (JAX's engine serves
them with that one ranking all the same).  Either
aggregator but the EmbeddingNet, with or without the cls token, is served:
the index keeps the music tokens without the cls row, and a query's video
duration comes from the raw frame mask, as JAX's.  An agg_module="mlp"
model raises ValueError at the index build and at the engine: JAX's engine
hands its towers no BatchNorm buffers and fails there.

With `mesh=` (a core.mesh.Mesh) the index is sharded over the ranks of one
axis, as JAX's (mgsv_tpu/serve/engine.py:154-182, :265-311), so the
engine serves a catalog larger than one card holds.  The index is padded
to a multiple of the axis size with tracks of one valid zero snippet and
zero embeddings, and each rank keeps only its shard on its device,
replicated over the other axis.  A query runs the video tower whole on
every rank, the dual plus pooled similarity of the rank's shard ([B, M/n],
the blocked plain path), an all-gather of it over the axis group to
[B, M_pad] with the pad columns at -inf, and top-k, the same on every
rank.  Each rank then localizes only the (query, candidate) pairs whose
track it holds (none: no launch), and one all-reduce over the axis group
of a [B * k, 3] buffer (start, end, score; zeros where another rank holds
the pair) gives every rank the whole answer: tokens do not move.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, all_reduce_sum, check_mesh
from mgsv_tpu_torch.eval.similarity import (dual_similarity, gather_columns, pad_tracks,
                                            xpool_similarity_blocked)
from mgsv_tpu_torch.models import layers as L
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.spans import span_cw_to_se


@dataclasses.dataclass
class MusicIndex:
    """Frozen music-tower outputs; the `.npz` format of the JAX engine, so
    indexes built by either package load in both."""

    music_ids: List[str]
    music_embs: np.ndarray     # [M, D]
    seg_tokens: np.ndarray     # [M, S, D]
    seg_masks: np.ndarray      # [M, S]

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, music_ids=np.asarray(self.music_ids),
            music_embs=self.music_embs, seg_tokens=self.seg_tokens,
            seg_masks=self.seg_masks)

    @staticmethod
    def load(path: str) -> "MusicIndex":
        z = np.load(path, allow_pickle=False)
        return MusicIndex(
            music_ids=[str(x) for x in z["music_ids"]],
            music_embs=z["music_embs"], seg_tokens=z["seg_tokens"],
            seg_masks=z["seg_masks"])


def check_aggregator(cfg: Config) -> None:
    """Raise ValueError for agg_module="mlp", which JAX's engine cannot
    serve (mgsv_tpu/serve/engine.py:76, :295-297)."""
    if cfg.model.agg_module == "mlp":
        raise ValueError(
            "the serving engine does not serve agg_module='mlp': JAX's engine hands its "
            "towers the params collection alone, without the EmbeddingNet's batch_stats, "
            "and fails with flax's ScopeCollectionNotFound ('bn1_mean')")


@torch.no_grad()
def build_music_index(model: MaDe, music_ids: Sequence[str],
                      segment_feats: np.ndarray,    # [M, S, ast_dim]
                      segment_masks: np.ndarray,    # [M, S]
                      batch_size: int = 128) -> MusicIndex:
    """Run the music tower over a collection once, on the model's device;
    raises where `check_aggregator` does."""
    check_aggregator(model.cfg)
    device = next(model.parameters()).device
    tokens_all, embs_all, masks_all = [], [], []
    for i in range(0, len(music_ids), batch_size):
        feats = torch.as_tensor(segment_feats[i:i + batch_size], dtype=torch.float32,
                                device=device)
        masks = torch.as_tensor(segment_masks[i:i + batch_size], dtype=torch.float32,
                                device=device)
        # plain temporal layers, as the JAX engine's Tower (no `fused`)
        tokens, emb, masks = model.music_tower(feats, masks, plain_temporal=True)
        tokens_all.append(tokens.cpu().numpy())
        embs_all.append(emb.cpu().numpy())
        masks_all.append(masks.cpu().numpy())
    return MusicIndex(music_ids=list(music_ids),
                      music_embs=np.concatenate(embs_all),
                      seg_tokens=np.concatenate(tokens_all),
                      seg_masks=np.concatenate(masks_all))


# the vmr_loss whose evaluation ranking (eval/evaluator.py::corpus_similarity)
# is the engine's: the pooled X-Pool similarity plus the dual one
SERVED_LOSSES = ("dual_single_loss_fuse", "dual_single_sim_fuse")


def _bucket(n: int) -> int:
    """Next power of two: every batch size maps to one of log2(max_b)
    launch shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


class RetrievalEngine:
    """Query-time engine: video features -> top-k tracks + moments.

    index_dtype "bfloat16" halves the device-resident token store; compute
    promotes it back to float32, so only stored values round.  mesh: a
    core.mesh.Mesh whose `mesh_axis` ("dp" or "mp") the index is sharded
    over (module docstring).  Under a mesh every rank must call `query` and
    `warmup` with the same inputs, as every rank calls `evaluate` (SPMD):
    each query takes collectives over the axis group."""

    def __init__(self, model: MaDe, cfg: Config, index: MusicIndex,
                 sim_block_size: int = 256,
                 use_fused_kernels: Optional[bool] = None,
                 index_dtype: str = "float32", mesh=None, mesh_axis: str = DATA_AXIS):
        m = cfg.model
        check_mesh(mesh)
        if mesh_axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"mesh_axis={mesh_axis!r}: expected {DATA_AXIS!r} or "
                             f"{MODEL_AXIS!r}")
        check_aggregator(cfg)
        unserved = {"vmr_fusion": (m.vmr_fusion, model.xpool is not None),
                    "vmr_loss": (cfg.loss.vmr_loss, cfg.loss.vmr_loss in SERVED_LOSSES),
                    "mml_fusion": (m.mml_fusion, m.mml_fusion == "concat"),
                    "moment_query_type": (m.moment_query_type, m.moment_query_type == "video"),
                    "mml_localization": (m.mml_localization, m.mml_localization == "detr")}
        bad = [f"{k}={v!r}" for k, (v, ok) in unserved.items() if not ok]
        if bad:
            raise ValueError(f"RetrievalEngine serves the video-guided music X-Pool, concat "
                             f"fusion, the video moment query, the DETR heads and the "
                             f"vmr_loss {' or '.join(SERVED_LOSSES)}, whose evaluation ranks "
                             f"by the dual plus the pooled similarity (not 'dual', 'single', "
                             f"'dual_single_feature_fuse' or 'dual_single_oneloss'); not "
                             f"{', '.join(bad)}")
        self.model = model.eval()
        self.cfg = cfg
        self.index = index
        self.device = next(model.parameters()).device
        if use_fused_kernels is None:
            use_fused_kernels = self.device.type == "cuda"
        # the encoder-layer kernel is post-norm only (JAX engine.py:126)
        self.use_fused_kernels = use_fused_kernels and not m.detr_pre_norm
        self.sim_block_size = sim_block_size
        if index_dtype in ("bf16", "bfloat16"):
            store_dt = torch.bfloat16
        elif index_dtype in ("f32", "float32"):
            store_dt = torch.float32
        else:
            raise ValueError(f"unsupported index_dtype: {index_dtype}")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self._n_valid = len(index.music_ids)
        seg_tokens = torch.as_tensor(index.seg_tokens)
        seg_masks = torch.as_tensor(index.seg_masks, dtype=torch.float32)
        music_embs = torch.as_tensor(index.music_embs)
        self._first = 0           # the global index of this rank's first track
        if mesh is not None:
            # pad tracks of one valid snippet and a zero embedding; they never rank (_run)
            n = mesh.shape[mesh_axis]
            seg_tokens, seg_masks = pad_tracks(seg_tokens, seg_masks, n)
            music_embs = torch.cat([music_embs, music_embs.new_zeros(
                seg_tokens.shape[0] - self._n_valid, music_embs.shape[1])])
            per = seg_tokens.shape[0] // n
            self._first = mesh.index(mesh_axis) * per
            own = slice(self._first, self._first + per)
            seg_tokens, seg_masks, music_embs = seg_tokens[own], seg_masks[own], music_embs[own]
        self._seg_tokens = seg_tokens.to(self.device).to(store_dt)
        self._seg_masks = seg_masks.to(self.device)
        self._music_embs = music_embs.to(self.device).to(store_dt)
        self._autocast = cfg.model.compute_dtype == "bfloat16"

    def _localize_core(self, tokens, video_emb, fmask, seg_tokens, seg_masks, v_dur):
        """Localization head over (video, candidate-track) pair rows: the
        DETR fuses the video tower's tokens with the index's music tokens
        (concat fusion), then the class and span heads pick each pair's
        best moment.  Returns (spans [N, 2] seconds, scores [N])."""
        cfg, m, model = self.cfg, self.cfg.model, self.model
        fused = torch.cat([tokens, seg_tokens], dim=1)
        fused_mask = torch.cat([fmask, seg_masks], dim=1)
        fused, fused_mask = L.pad_fused_sequence(fused, fused_mask, m.detr_seq_pad_multiple)
        pos = L.position_embedding_sine(fused_mask, m.dim_input)
        target = video_emb[:, None, :].expand(-1, m.num_moment_queries, -1)
        query_embed = model.decoder_query_embed.weight
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self._autocast and not self.use_fused_kernels):
            hidden, _ = model.detr_transformer(fused, fused_mask, pos, query_embed, target,
                                               plain=not self.use_fused_kernels)
        last = hidden[-1].float()
        logits = model.class_embed(last)
        spans_cw = torch.sigmoid(model.span_embed(last))
        if m.predict_center:
            width = (v_dur / cfg.data.max_m_duration)[:, None, None]
            spans_cw = torch.cat([spans_cw, width.expand(*spans_cw.shape[:-1], 1)], dim=-1)
        score = torch.softmax(logits, dim=-1)[..., cfg.loss.foreground_label]
        best = score.argmax(dim=-1)
        spans_se = span_cw_to_se(spans_cw) * cfg.data.max_m_duration
        rows = torch.arange(best.shape[0], device=best.device)
        return spans_se[rows, best], score[rows, best]

    @torch.no_grad()
    def _run(self, frame_feats, frame_mask, top_k):
        model = self.model
        # plain temporal layers, as the JAX engine's Tower (no `fused`)
        tokens, video_emb, fmask = model.video_tower(frame_feats, frame_mask,
                                                     plain_temporal=True)
        sims = dual_similarity(video_emb, self._music_embs.float())
        sims = sims + xpool_similarity_blocked(
            model.xpool, video_emb, self._seg_tokens,
            self._seg_masks if self.cfg.model.fusion_mask else None,
            block_size=min(self.sim_block_size, self._seg_tokens.shape[0]))  # [B, shard]
        if self.mesh is not None:
            sims = gather_columns(sims, self.mesh, self.mesh_axis)       # [B, M_pad]
            pads = torch.arange(sims.shape[1], device=sims.device) >= self._n_valid
            sims = sims.masked_fill(pads, float("-inf"))
        top_sims, order = torch.topk(sims, top_k, dim=1)        # [B, k]
        cand = order.reshape(-1)
        # video duration from the 1 fps frame mask
        v_dur = frame_mask.sum(dim=-1)
        if self.mesh is not None:
            spans, scores = self._localize_shard(tokens, video_emb, fmask, v_dur, cand, top_k)
        else:
            rep = lambda t: t.repeat_interleave(top_k, dim=0)
            spans, scores = self._localize_core(
                rep(tokens), rep(video_emb), rep(fmask),
                self._seg_tokens[cand].float(), self._seg_masks[cand], rep(v_dur))
        b = frame_feats.shape[0]
        return order, top_sims, spans.reshape(b, top_k, 2), scores.reshape(b, top_k)

    def _localize_shard(self, tokens, video_emb, fmask, v_dur, cand, top_k):
        """Localization of the (query, candidate) pairs whose track this
        rank's shard holds, the other pairs' rows zero, summed over the axis
        group: every rank gets (spans [B * k, 2], scores [B * k]).  A rank
        that holds no candidate launches nothing, and still joins the sum."""
        local = cand - self._first
        pair = ((local >= 0) & (local < self._seg_tokens.shape[0])).nonzero().squeeze(1)
        out = torch.zeros(cand.shape[0], 3, device=cand.device)
        if pair.numel():
            rows, mine = pair // top_k, local[pair]
            spans, scores = self._localize_core(
                tokens[rows], video_emb[rows], fmask[rows],
                self._seg_tokens[mine].float(), self._seg_masks[mine], v_dur[rows])
            out[pair] = torch.cat([spans, scores[:, None]], dim=1)
        out = all_reduce_sum(out, self.mesh, self.mesh_axis)
        return out[:, :2], out[:, 2]

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
               top_k: int = 5) -> None:
        """Run one query per batch bucket before traffic: builds the CUDA
        kernel and warms the allocator, so no client pays for them."""
        F, vit = self.cfg.data.max_v_frames, self.cfg.data.vit_dim
        for b in sorted({_bucket(int(x)) for x in batch_sizes}):
            mask = np.zeros((b, F), np.float32)
            mask[:, 0] = 1.0
            self.query(np.zeros((b, F, vit), np.float32), mask, top_k=top_k)

    def query(self, frame_feats: np.ndarray, frame_mask: np.ndarray,
              top_k: int = 5) -> List[Dict]:
        """frame_feats [B, F, vit_dim], frame_mask [B, F] -> per query a dict
        of ranked music ids and scores and a moment (seconds) per candidate.

        top_k is clamped to the catalog and run at its power-of-two bucket;
        the batch is padded to its bucket with rows that keep frame 0 valid,
        so the attention softmax never sees an all-masked row."""
        k_req = max(1, min(int(top_k), self._n_valid))
        k_run = min(_bucket(k_req), self._n_valid)
        b_real = frame_feats.shape[0]
        b_pad = _bucket(b_real)
        feats = np.zeros((b_pad,) + tuple(frame_feats.shape[1:]), np.float32)
        mask = np.zeros((b_pad, frame_feats.shape[1]), np.float32)
        mask[b_real:, 0] = 1.0
        feats[:b_real] = frame_feats
        mask[:b_real] = frame_mask
        order, top_sims, spans, scores = (
            t[:b_real, :k_req].cpu().numpy() for t in self._run(
                torch.from_numpy(feats).to(self.device),
                torch.from_numpy(mask).to(self.device), k_run))
        return [{
            "music_ids": [self.index.music_ids[j] for j in order[i]],
            "retrieval_scores": top_sims[i].tolist(),
            "moments": spans[i].tolist(),
            "moment_scores": scores[i].tolist(),
        } for i in range(b_real)]
