"""A full evaluation: forward every batch, corpus similarity, metrics;
ported from mgsv_tpu/eval/evaluator.py (single device).

One implementation serves the training loop and the evaluation CLI, as in
the JAX package.  The per-batch outputs stay on the device until the one
corpus similarity; the final partial batch is padded (repeat the last row)
and its padding excluded from every metric; the loss of each batch is
weighted by its valid rows.  A host dataset is fed by the input pipeline;
a device-resident one (data/device_data.py) takes the resident pass, the
twin of JAX's single-dispatch scan: the padded order's indices go to the
device once, each batch is gathered there, and no batch waits on the host,
with outputs equal to the host loop's bit for bit.  The corpus X-Pool
similarity runs on the evaluation kernel
(ops/cuda/xpool_sim.py::xpool_sim_eval) on a CUDA device and blocked in
plain PyTorch on the CPU, unless `use_fused_sim` says otherwise; the
ranking runs where the similarity lies.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.dataset import MgsvDataset
from mgsv_tpu_torch.data.device_data import DeviceResidentData, gather_batch
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.eval import metrics as M
from mgsv_tpu_torch.eval.similarity import (dual_similarity, xpool_sim_fused,
                                            xpool_similarity_blocked)
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.step import make_eval_step


@torch.no_grad()
def evaluate(
    model: MaDe,
    dataset: MgsvDataset | DeviceResidentData,
    cfg: Config,
    batch_size: Optional[int] = None,
    eval_step=None,
    sim_block_size: int = 256,
    mesh=None,
    use_fused_sim: Optional[bool] = None,
    fused_decoder: bool = False,
) -> Dict[str, Any]:
    """Returns {"loss", "retrieval", "localization", "composite", "ranks",
    "ious", "pred_spans", "video_ids", "music_ids", "ret_results"}, as the
    JAX evaluate does, and "sim", the [N, N] similarity on the device, for
    the model's weights, on the model's device.  use_fused_sim None takes the
    evaluation kernel on a CUDA device and the blocked plain path on the
    CPU.  fused_decoder: the eval step's DETR decoder on the decoder-layer
    kernel (when no eval_step is given)."""
    if mesh is not None:
        raise NotImplementedError("multi-device evaluation is not ported yet "
                                  "(ROADMAP.md, queue 1: multi-GPU)")
    device = next(model.parameters()).device
    batch_size = batch_size or cfg.train.batch_size_val
    eval_step = eval_step or make_eval_step(model, cfg, fused_decoder)
    if use_fused_sim is None:
        use_fused_sim = device.type == "cuda"

    video_embs, music_embs, seg_tokens, seg_masks = [], [], [], []
    ious, pred_spans, losses, weights = [], [], [], []

    def collect(out, valid_rows: int) -> None:
        video_embs.append(out["video_emb"])
        music_embs.append(out["music_emb"])
        seg_tokens.append(out["seg_tokens"])
        seg_masks.append(out["segment_mask"])
        ious.append(out["iou"])
        pred_spans.append(out["pred_spans_sec"])
        # the padded final batch's in-batch loss still sees its padding rows
        # as extra negatives; weighting by valid rows keeps its share small
        losses.append(out["loss"])
        weights.append(valid_rows)

    if isinstance(dataset, DeviceResidentData):
        if dataset.device != device:
            raise ValueError(f"resident data on {dataset.device}, model on {device}")
        n = len(dataset)
        pad = (-n) % batch_size
        order = np.concatenate([np.arange(n), np.full(pad, n - 1)])
        chunks = torch.from_numpy(order.reshape(-1, batch_size)).to(device)
        for i, idx in enumerate(chunks):
            collect(eval_step(gather_batch(dataset.tree, idx)),
                    batch_size - pad if i == len(chunks) - 1 else batch_size)
        video_ids, music_ids = list(dataset.index.video_ids), list(dataset.index.music_ids)
    else:
        video_ids, music_ids = [], []
        for batch, meta in prefetch_epoch(dataset, batch_size, shuffle=False,
                                          drop_last=False, device=device):
            collect(eval_step(batch), int(meta.valid.sum()))
            video_ids.extend(v for v, ok in zip(meta.video_ids, meta.valid) if ok)
            music_ids.extend(m for m, ok in zip(meta.music_ids, meta.valid) if ok)

    # padding rows exist only at the tail of the final batch
    n = len(video_ids)
    sim = corpus_similarity(model, torch.cat(video_embs)[:n], torch.cat(music_embs)[:n],
                            torch.cat(seg_tokens)[:n], torch.cat(seg_masks)[:n], cfg,
                            block_size=sim_block_size, use_fused_kernel=use_fused_sim)
    ious = torch.cat(ious)[:n].cpu().numpy()

    ret_metrics, ranks, ret_results = M.recall_metrics(sim, music_ids)
    return {
        "loss": (float(np.average(torch.stack(losses).cpu().tolist(), weights=weights))
                 if losses else 0.0),
        "retrieval": ret_metrics,
        "localization": M.iou_metrics(ious),
        "composite": M.composite_metrics(ranks, ious),
        "ranks": ranks,
        "ious": ious,
        "pred_spans": torch.cat(pred_spans)[:n].cpu().numpy(),
        "video_ids": video_ids,
        "music_ids": music_ids,
        "ret_results": ret_results,
        "sim": sim,
    }


@torch.no_grad()
def corpus_similarity(
    model: MaDe,
    video_embs: torch.Tensor,      # [N, D]
    music_embs: torch.Tensor,      # [N, D]
    seg_tokens: torch.Tensor,      # [N, S, D]
    seg_masks: torch.Tensor,       # [N, S]
    cfg: Config,
    block_size: int = 256,
    use_fused_kernel: bool = False,
) -> torch.Tensor:
    """[N, N] similarity fusion per vmr_loss, train-MaDe.py:577-604, on the
    device of the inputs, as JAX's: the dual similarity without X-Pool or
    for "dual"; the video-guided music X-Pool's pooled similarity for
    "single", plus the dual one for the two fuse losses, and with the
    pooled features averaged with the music embedding for
    "dual_single_feature_fuse" (blocked, in plain PyTorch).
    use_fused_kernel takes the pooled X-Pool similarity from the evaluation
    kernel (`xpool_sim_fused`), else from the blocked plain path
    (`xpool_similarity_blocked`).  A loss that needs the music X-Pool where
    vmr_fusion builds none (XA-video) raises ValueError, where JAX's reads
    a parameter subtree that does not exist; "dual_single_oneloss" raises
    too, as JAX's does."""
    lc, m = cfg.loss, cfg.model
    mask = seg_masks if m.fusion_mask else None
    block = min(block_size, len(seg_tokens))

    def xpool():
        if model.xpool is None:
            raise ValueError(
                f"vmr_loss={lc.vmr_loss!r} ranks by the video-guided music X-Pool, which "
                f"vmr_fusion={m.vmr_fusion!r} does not build")
        return model.xpool

    def pooled_sim():
        if use_fused_kernel:
            return xpool_sim_fused(video_embs, seg_tokens, mask, xpool())
        return xpool_similarity_blocked(xpool(), video_embs, seg_tokens, mask, block_size=block)

    if "XA" not in m.vmr_fusion or lc.vmr_loss == "dual":
        return dual_similarity(video_embs, music_embs)
    if lc.vmr_loss == "single":
        return pooled_sim()
    if lc.vmr_loss in ("dual_single_sim_fuse", "dual_single_loss_fuse"):
        return pooled_sim() * 1.0 + dual_similarity(video_embs, music_embs) * 1.0
    if lc.vmr_loss == "dual_single_feature_fuse":
        return xpool_similarity_blocked(xpool(), video_embs, seg_tokens, mask, block_size=block,
                                        music_embs=music_embs)
    raise ValueError(f"unsupported vmr_loss for eval: {lc.vmr_loss}")
