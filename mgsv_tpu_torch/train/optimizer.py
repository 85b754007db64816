"""Three-group Adam, ported from mgsv_tpu/train/optimizer.py.

The reference's prep_optimizer builds Adam over three parameter groups:
temporal (projections + temporal transformers, lr = matching_lr), matching
(X-Pool + logit_scale, lr = matching_lr) and detection (DETR + heads, lr =
detection_lr), each clipped by its own global gradient norm.  The update
is optax's, step for step:

    g     <- g * max_norm / |g|_group        only when |g|_group >= max_norm
    mu    <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
    p     <- p - lr(k) * (mu / (1 - b1^(k+1))) / (sqrt(nu / (1 - b2^(k+1))) + eps)

with k the update count (0 first).  Not torch.nn.utils.clip_grad_norm_,
which adds 1e-6 to the norm, nor torch.optim.Adam, whose schedule and eps
placement differ.  `decoder_query_embed` belongs to no reference group and
never updates unless train_query_embed is set.  Parameter gradients are
read, never rewritten.  `state_dict` holds the update count and mu, nu by
parameter name, so a checkpoint restores into a fresh optimizer and a
resumed run replays bit for bit (the step's dropout is keyed on the
count).  Gradient accumulation is still to port (ROADMAP.md).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import torch
from torch import nn

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.train.schedule import make_schedule

TEMPORAL, MATCHING, DETECTION, FROZEN = "temporal", "matching", "detection", "frozen"

# top-level MaDe modules (reference state-dict names) -> group
_GROUP_OF_MODULE = {
    "vit_proj": TEMPORAL, "ast_proj": TEMPORAL,
    "video_transformer": TEMPORAL, "audio_transformer": TEMPORAL,
    "share_transformer": TEMPORAL,
    "video_guided_to_music_pooling_cross_transformer": MATCHING,
    "music_guided_to_video_pooling_cross_transformer": MATCHING,
    "logit_scale": MATCHING,
    "video_music_fusion_cross_transformer": DETECTION,
    "detr_transformer": DETECTION, "span_embed": DETECTION, "class_embed": DETECTION,
    "moment_embed": DETECTION, "reg_mlp": DETECTION,
    "contrastive_align_projection_query": DETECTION,
    "contrastive_align_projection_vid": DETECTION,
    "decoder_query_embed": FROZEN,
}


def param_groups(model: nn.Module, train_query_embed: bool = False) -> Dict[str, List]:
    """{group: [(name, parameter)]} over every parameter of `model`."""
    groups: Dict[str, List] = {TEMPORAL: [], MATCHING: [], DETECTION: [], FROZEN: []}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        group = _GROUP_OF_MODULE.get(top)
        if group is None:
            raise KeyError(f"no optimizer group for parameter {name}")
        if top == "decoder_query_embed" and train_query_embed:
            group = DETECTION
        groups[group].append((name, p))
    return groups


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, as optax.global_norm: the
    norm of the per-tensor norms, in one multi-tensor launch."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class GroupedAdam:
    """Adam with per-group global-norm clipping and a schedule per group."""

    def __init__(self, model: nn.Module, cfg: Config, total_steps: int):
        t = cfg.train
        if t.gradient_accumulation_steps > 1:
            raise NotImplementedError("gradient accumulation is not ported yet (ROADMAP.md)")
        total_steps = max(1, total_steps)
        warmup = int(total_steps * t.warmup_rate)
        sched = lambda lr: make_schedule(t.scheduler, lr, warmup, total_steps,
                                         decay_rate=t.decay_rate,
                                         lr_update_rate=t.lr_update_rate)
        self.schedules = {TEMPORAL: sched(t.matching_lr), MATCHING: sched(t.matching_lr),
                          DETECTION: sched(t.detection_lr)}
        self.groups = param_groups(model, t.train_query_embed)
        self.b1, self.b2, self.eps, self.max_norm = t.adam_b1, t.adam_b2, t.adam_eps, t.max_grad_norm
        self.state = {name: (torch.zeros_like(p), torch.zeros_like(p))
                      for g in self.schedules for name, p in self.groups[g]}
        self.count = 0

    def state_dict(self) -> Dict[str, Any]:
        """{"count", "mu": {name: tensor}, "nu": {name: tensor}}: the live
        moment tensors, not copies."""
        return {"count": self.count,
                "mu": {name: mu for name, (mu, _) in self.state.items()},
                "nu": {name: nu for name, (_, nu) in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a `state_dict` (any device) into this optimizer's tensors;
        the names must be this optimizer's, exactly."""
        for key in ("mu", "nu"):
            if state[key].keys() != self.state.keys():
                missing = sorted(self.state.keys() ^ state[key].keys())
                raise KeyError(f"optimizer state {key}: names differ: {missing[:5]}")
        for name, (mu, nu) in self.state.items():
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' .grad (None counts as zero), each
        group's arithmetic in multi-tensor (torch._foreach_*) launches, in
        optax's operation order."""
        k = self.count + 1
        for group, schedule in self.schedules.items():
            named = self.groups[group]
            if not named:
                continue
            params = [p for _, p in named]
            device = params[0].device
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            mus = [self.state[name][0] for name, _ in named]
            nus = [self.state[name][1] for name, _ in named]
            # made on the device (a copy from the host would wait for it)
            bc1, bc2 = (1.0 - torch.full((), b, dtype=torch.float32, device=device) ** k
                        for b in (self.b1, self.b2))
            # g / norm * max_norm where norm >= max_norm, else g / 1 * 1 = g
            norm = global_norm(grads)
            clip = norm >= self.max_norm
            grads = torch._foreach_div(grads, torch.where(clip, norm, torch.ones_like(norm)))
            torch._foreach_mul_(grads, torch.where(clip, torch.full_like(norm, self.max_norm),
                                                   torch.ones_like(norm)))
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - self.b1))
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - self.b2))
            # p -= lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mus, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, schedule(self.count))
            torch._foreach_sub_(params, update)
        self.count += 1


def log_param_audit(logger: logging.Logger, model: nn.Module,
                    train_query_embed: bool = False) -> Dict[str, Any]:
    """Log the startup trainable/frozen audit by optimizer group
    (count_parameters / show_model_architecture, train-MaDe.py:209-304);
    returns {group: {"params": N, "modules": {top-level module: N}}}."""
    audit: Dict[str, Any] = {g: {"params": 0, "modules": {}}
                             for g in (TEMPORAL, MATCHING, DETECTION, FROZEN)}
    for group, named in param_groups(model, train_query_embed).items():
        for name, p in named:
            top = name.split(".")[0]
            audit[group]["params"] += p.numel()
            audit[group]["modules"][top] = audit[group]["modules"].get(top, 0) + p.numel()
    total = sum(g["params"] for g in audit.values())
    trainable = total - audit[FROZEN]["params"]
    logger.info("parameter audit: %.3fM total, %.3fM trainable, %.3fM frozen",
                total / 1e6, trainable / 1e6, audit[FROZEN]["params"] / 1e6)
    for group in (TEMPORAL, MATCHING, DETECTION, FROZEN):
        mods = ", ".join(f"{name} {n / 1e6:.3f}M"
                         for name, n in sorted(audit[group]["modules"].items()))
        logger.info("  group %-9s %8.3fM  [%s]", group, audit[group]["params"] / 1e6,
                    mods or "-")
    return audit


def make_optimizer(model: nn.Module, cfg: Config, total_steps: int) -> GroupedAdam:
    """total_steps: updates over the run (the schedules' horizon)."""
    return GroupedAdam(model, cfg, total_steps)
