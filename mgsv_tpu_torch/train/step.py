"""The training and evaluation steps, ported from mgsv_tpu/train/step.py.

One training step: forward (both tasks, dropout on), the dual-task loss,
backward, the three-group clipped Adam update, and the train-time top-1
span decode and IoU the reference computes every batch.  The X-Pool
similarity and the DETR encoder layers run on the CUDA kernels, forward and
backward.  The evaluation step is the same forward without dropout and
without gradients, its loss, and the decoded span's IoU.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.spans import eval_iou_batch, span_cw_to_se
from mgsv_tpu_torch.train.objective import total_loss
from mgsv_tpu_torch.train.optimizer import GroupedAdam, global_norm


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's dropout generator on `device`, keyed on (seed, step) as
    the JAX step keys its rng with fold_in(rng, step)."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def decode_top_span(outputs: Dict[str, Any], cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 predicted span in seconds [B, 2] and its foreground score [B]:
    softmax score over the queries, (center, width) -> (start, end) times
    max_m_duration, best query."""
    logits = outputs["pred_logits_layers"][-1]           # [B, Q, 2]
    spans_cw = outputs["pred_spans_layers"][-1]          # [B, Q, 2]
    scores = torch.softmax(logits, dim=-1)[..., cfg.loss.foreground_label]
    spans_se = span_cw_to_se(spans_cw) * cfg.data.max_m_duration
    best = scores.argmax(dim=-1)
    rows = torch.arange(best.shape[0], device=best.device)
    return spans_se[rows, best], scores[rows, best]


def make_train_step(model: MaDe, cfg: Config, optimizer: GroupedAdam,
                    fused_decoder: bool = False):
    """step(batch) -> log.  batch: tensors on the model's device, keyed as
    data/example_batch.py makes them.  The log holds the losses,
    train_iou [B] and grad_norm (the norm over every gradient, frozen
    parameters included, as optax.global_norm(grads) is), as tensors; with
    gradient accumulation grad_norm is this micro-batch's, as JAX logs it.
    After the step each parameter's .grad holds its gradient.  Dropout, the
    kernels' Philox seeds included, draws from (cfg.train.seed, the
    optimizer's micro_step): JAX folds state.step into its rng, and flax's
    apply_gradients advances state.step on every micro-batch.
    fused_decoder: the DETR decoder on the decoder-layer kernel
    (MaDe.forward; it raises for a detr_dropout above 0)."""
    params = list(model.parameters())

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        generator = step_generator(cfg.train.seed, optimizer.micro_step,
                                   batch["frame_feats"].device)
        for p in params:
            p.grad = None
        out = model(batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                    batch["segment_mask"], v_duration=batch.get("v_duration"),
                    generator=generator, fused_decoder=fused_decoder)
        loss, log = total_loss(out, batch["spans_target"], cfg,
                               music_codes=batch.get("music_codes"))
        loss.backward()
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])
        optimizer.step()
        with torch.no_grad():
            spans_sec, _ = decode_top_span(out, cfg)
            log = {k: v.detach() for k, v in log.items()}
            log["train_iou"] = eval_iou_batch(batch["gt_moment"][:, 0, :], batch["m_duration"],
                                              spans_sec, cfg.data.max_m_duration)
            log["grad_norm"] = grad_norm
        return log

    return train_step


def make_eval_step(model: MaDe, cfg: Config, fused_decoder: bool = False):
    """eval_step(batch) -> the JAX eval step's outputs as tensors on the
    model's device: the embeddings, snippet tokens and mask the corpus
    similarity needs, the top-1 span in seconds, its score and IoU [B], and
    the three losses (the in-batch retrieval loss, no music codes).
    fused_decoder: the DETR decoder on the decoder-layer kernel."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model(batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                    batch["segment_mask"], v_duration=batch.get("v_duration"),
                    fused_decoder=fused_decoder)
        loss, log = total_loss(out, batch["spans_target"], cfg)
        spans_sec, score = decode_top_span(out, cfg)
        return {
            "video_emb": out["video_emb"],
            "music_emb": out["music_emb"],
            "seg_tokens": out["seg_tokens"],
            "segment_mask": out["segment_mask"],
            "pred_spans_sec": spans_sec,
            "pred_score": score,
            "iou": eval_iou_batch(batch["gt_moment"][:, 0, :], batch["m_duration"], spans_sec,
                                  cfg.data.max_m_duration),
            "loss": loss,
            "retrieval_loss": log["retrieval_loss"],
            "localization_loss": log["localization_loss"],
        }

    return eval_step
