"""The training and evaluation steps, ported from mgsv_tpu/train/step.py.

One training step: forward (both tasks, dropout on), the dual-task loss,
backward, the three-group clipped Adam update, and the train-time top-1
span decode and IoU the reference computes every batch.  The X-Pool
similarity and the DETR encoder layers run on the CUDA kernels, forward and
backward.  The evaluation step is the same forward without dropout and
without gradients, its loss, and the decoded span's IoU.

Over a data-parallel mesh (core/mesh.py) both steps take this rank's rows
of the global batch and compute the global batch's loss (train/
objective.py).  The training step sums the ranks' partial gradients once
per update (core/mesh.py::sync_gradients; with gradient accumulation the
optimizer does, at the update), so every rank clips by the same norm and
applies the same update.  The dp index is folded into the step's dropout
generator (core/mesh.py::fold_axis_into_seed), from which every plain
dropout mask and every kernel's Philox seed is drawn, so one local row
draws other masks at each dp index, as JAX folds axis_index("dp") into its
kernels' seeds; the mp replicas of a dp index draw the same masks and
keep the same weights.  On a single CUDA device the training step replays
as CUDA graphs (train/graphs.py).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.mesh import Mesh, fold_axis_into_seed, sync_gradients
from mgsv_tpu_torch.core.profiling import span
from mgsv_tpu_torch.models.layers import StepSeeds
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.spans import eval_iou_batch, span_cw_to_se
from mgsv_tpu_torch.train.graphs import StepGraphs, eager_phase, engages
from mgsv_tpu_torch.train.objective import total_loss
from mgsv_tpu_torch.train.optimizer import GroupedAdam, global_norm


def step_key(seed: int, step: int, dp_index: int = 0) -> int:
    """The seed of the step's dropout generator, keyed on (seed, step) as
    the JAX step keys its rng with fold_in(rng, step), with the dp index
    folded into the seed (dp index 0 keeps it)."""
    return int(np.random.SeedSequence([fold_axis_into_seed(seed, dp_index), step])
               .generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int, device: torch.device, dp_index: int = 0
                   ) -> torch.Generator:
    """The step's dropout generator on `device`: seeded with `step_key`."""
    return torch.Generator(device=device).manual_seed(step_key(seed, step, dp_index))


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
                    fused_decoder: bool = False, mesh: Optional[Mesh] = None,
                    cuda_graphs: bool = True):
    """step(batch) -> log.  batch: tensors on the model's device, keyed as
    data/example_batch.py makes them.  The log holds the losses,
    train_iou [B] and grad_norm (the norm over every gradient, frozen
    parameters included, as optax.global_norm(grads) is), as tensors of
    their own; with gradient accumulation grad_norm is this micro-batch's,
    as JAX logs it.  After the step each parameter's .grad holds its
    gradient.  Dropout, the kernels' Philox seeds included, draws from
    (cfg.train.seed, the optimizer's micro_step): JAX folds state.step into
    its rng, and flax's apply_gradients advances state.step on every
    micro-batch; one generator on the model's device, re-seeded in place
    each step with `step_key`, is the step's dropout generator.
    fused_decoder: the DETR decoder on the decoder-layer kernel
    (MaDe.forward; it raises for a detr_dropout above 0).  The step is the
    span "step" (core/profiling.py; its identifier the micro_step) with the
    children "step.forward", "step.loss" (the losses, the matcher
    included, and the log's decoded spans), "step.backward" and
    "step.optimizer" (the gradient sync, the norm and the update).

    On a CUDA device without a mesh and at gradient_accumulation_steps 1
    the step replays its phases as CUDA graphs (train/graphs.py): the first
    call of a set of batch shapes runs eagerly, the second captures, later
    calls replay, each replay also recording the span "step.replay" (the
    host's preparation of its seeds, scalars and inputs); cuda_graphs=False
    keeps every call eager.  Either way one body runs, and its results are
    the same bit for bit.

    mesh: the batch is this rank's rows (their music codes coded over the
    global batch); the losses in the log are the global batch's and
    train_iou is this rank's rows.  At gradient_accumulation_steps 1 the
    .grad after the step is the global gradient; above 1 it is this rank's
    share, the optimizer sums the ranks' accumulated mean at the update,
    and the log has no grad_norm (the micro-batch's global norm would take
    a sync of its own)."""
    params = list(model.parameters())
    if optimizer.mesh != mesh:
        raise ValueError(f"the step's mesh {mesh} is not its optimizer's {optimizer.mesh}")
    sync_now = mesh is not None and optimizer.k == 1
    device = params[0].device
    generator = torch.Generator(device=device)
    dp_index = 0 if mesh is None else mesh.dp_index

    def loss_and_log(out, batch):
        loss, log = total_loss(out, batch["spans_target"], cfg,
                               music_codes=batch.get("music_codes"), mesh=mesh)
        with torch.no_grad():
            spans_sec, _ = decode_top_span(out, cfg)
            log = {k: v.detach() for k, v in log.items()}
            log["train_iou"] = eval_iou_batch(batch["gt_moment"][:, 0, :], batch["m_duration"],
                                              spans_sec, cfg.data.max_m_duration)
        return loss, log

    def update():
        grads = [p.grad for p in params if p.grad is not None]
        if sync_now:
            sync_gradients(grads, mesh)
        grad_norm = global_norm(grads) if mesh is None or sync_now else None
        optimizer.step()
        return grad_norm

    def body(batch: Dict[str, torch.Tensor], phase) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        out = phase("step.forward", lambda: model(
            batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
            batch["segment_mask"], v_duration=batch.get("v_duration"), generator=generator,
            fused_decoder=fused_decoder, mesh=mesh))
        loss, log = phase("step.loss", lambda: loss_and_log(out, batch))
        phase("step.backward", loss.backward)
        grad_norm = phase("step.optimizer", update)
        if grad_norm is not None:
            log["grad_norm"] = grad_norm
        return log

    graphs = (StepGraphs(body, params, optimizer, generator)
              if cuda_graphs and engages(device, mesh, optimizer.k) else None)
    seeds = StepSeeds(device) if device.type == "cuda" and graphs is None else None

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("step", step=optimizer.micro_step):
            key = step_key(cfg.train.seed, optimizer.micro_step, dp_index)
            generator.manual_seed(key)
            if graphs is not None:
                return graphs(batch, key)
            with seeds.drawing() if seeds is not None else contextlib.nullcontext():
                return body(batch, eager_phase)

    return train_step


def make_eval_step(model: MaDe, cfg: Config, fused_decoder: bool = False,
                   mesh: Optional[Mesh] = None):
    """eval_step(batch) -> the JAX eval step's outputs as tensors on the
    model's device: the embeddings, snippet tokens and mask the corpus
    similarity needs, the top-1 span in seconds, its score and IoU [B], and
    the three losses (the in-batch retrieval loss, no music codes).
    fused_decoder: the DETR decoder on the decoder-layer kernel.  mesh: the
    batch and the per-row outputs are this rank's rows, the losses the
    global batch's."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model(batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                    batch["segment_mask"], v_duration=batch.get("v_duration"),
                    fused_decoder=fused_decoder, mesh=mesh)
        loss, log = total_loss(out, batch["spans_target"], cfg, mesh=mesh)
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
            "loss": log["loss"],
            "retrieval_loss": log["retrieval_loss"],
            "localization_loss": log["localization_loss"],
        }

    return eval_step
