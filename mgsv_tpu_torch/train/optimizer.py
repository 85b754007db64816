"""Three-group Adam with gradient accumulation, ported from
mgsv_tpu/train/optimizer.py.

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
read, never rewritten.

With train.gradient_accumulation_steps = k > 1 the update is
optax.MultiSteps' (optax 0.2.6, transforms/_accumulation.py): each call
folds the micro-batch's gradient into the running mean,
acc <- acc + (g - acc) / (mini_step + 1), and only at mini_step = k - 1 runs
the clipped Adam above on that mean, advances the update count (and with it
the schedules and bias corrections) and zeroes the mean.  The schedules'
horizon is the run's micro-batches divided by k.  `state_dict` holds the
update count, mu, nu, the accumulation's mini_step, gradient_step and mean
by parameter name, so a checkpoint restores into a fresh optimizer and a
resumed run replays bit for bit (the step's dropout is keyed on
`micro_step`).

Over a (dp, mp) mesh (core/mesh.py) each rank's gradients are its share
of the global batch's, and its dp group's sum is the whole.  At k = 1 the
training step sums them before the update (train/step.py); at k > 1 each
rank folds its shares into its running mean and the update sums the means
over the dp group once, before the clipping: the sum is linear, so this
equals a sum at every micro-batch, with one all-reduce per update instead
of k.  Between updates each rank's mean is its own share, so `state_dict`
sums it over the dp group (every rank must call it) and `load_state_dict`
gives the sum to the rank of dp index 0 in each dp group and zeros to the
others.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.mesh import Mesh, all_reduce_sum, sync_gradients
from mgsv_tpu_torch.train.schedule import make_schedule

TEMPORAL, MATCHING, DETECTION, FROZEN = "temporal", "matching", "detection", "frozen"

# top-level MaDe modules (reference state-dict names; the cls tokens' and
# EmbeddingNets' are the port's own, in TEMPORAL as JAX's towers hold them)
# -> group.  The EmbeddingNets' running buffers are no parameters: Adam
# never sees them.
_GROUP_OF_MODULE = {
    "vit_proj": TEMPORAL, "ast_proj": TEMPORAL,
    "video_transformer": TEMPORAL, "audio_transformer": TEMPORAL,
    "share_transformer": TEMPORAL,
    "video_cls_token": TEMPORAL, "audio_cls_token": TEMPORAL,
    "video_embedding_net": TEMPORAL, "audio_embedding_net": TEMPORAL,
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


def group_of(name: str, train_query_embed: bool = False) -> str:
    """The optimizer group of the parameter `name` (a MaDe state-dict name)."""
    top = name.split(".")[0]
    group = _GROUP_OF_MODULE.get(top)
    if group is None:
        raise KeyError(f"no optimizer group for parameter {name}")
    if top == "decoder_query_embed" and train_query_embed:
        return DETECTION
    return group


def param_groups(model: nn.Module, train_query_embed: bool = False) -> Dict[str, List]:
    """{group: [(name, parameter)]} over every parameter of `model`."""
    groups: Dict[str, List] = {TEMPORAL: [], MATCHING: [], DETECTION: [], FROZEN: []}
    for name, p in model.named_parameters():
        groups[group_of(name, train_query_embed)].append((name, p))
    return groups


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, as optax.global_norm: the
    norm of the per-tensor norms, in one multi-tensor launch."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class GroupedAdam:
    """Adam with per-group global-norm clipping and a schedule per group,
    accumulating k micro-batches per update."""

    def __init__(self, model: nn.Module, cfg: Config, total_steps: int,
                 mesh: Optional[Mesh] = None):
        """total_steps: micro-batches over the run.  mesh: the ranks whose
        shares an accumulated update sums (module docstring)."""
        t = cfg.train
        self.mesh = mesh
        self.k = max(1, t.gradient_accumulation_steps)
        total_steps = max(1, total_steps // self.k)
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
        # the running mean of this update's micro-batch gradients (k > 1)
        self.acc = ({name: torch.zeros_like(p) for g in self.schedules
                     for name, p in self.groups[g]} if self.k > 1 else {})
        self.count = 0
        self.mini_step = 0

    @property
    def micro_step(self) -> int:
        """Micro-batches applied so far (the JAX train state's `step`)."""
        return self.count * self.k + self.mini_step

    def state_dict(self) -> Dict[str, Any]:
        """{"count", "mu", "nu", "mini_step", "gradient_step", "acc_grads"}:
        the live tensors, not copies; gradient_step (MultiStepsState's name)
        equals count.  Over a mesh the accumulated mean is the ranks' sum, a
        new tensor (a collective: every rank calls this)."""
        acc = dict(self.acc)
        if self.mesh is not None and self.acc:
            acc = {name: all_reduce_sum(a, self.mesh) for name, a in acc.items()}
        return {"count": self.count,
                "mu": {name: mu for name, (mu, _) in self.state.items()},
                "nu": {name: nu for name, (_, nu) in self.state.items()},
                "mini_step": self.mini_step, "gradient_step": self.count,
                "acc_grads": acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a `state_dict` (any device) into this optimizer's tensors;
        the names must be this optimizer's, exactly.  Over a mesh the rank
        of dp index 0 in each dp group takes the accumulated mean and the
        other ranks zeros, so each dp group's sum is the mean."""
        acc = state.get("acc_grads", {})
        for key, have, got in (("mu", self.state, state["mu"]),
                               ("nu", self.state, state["nu"]),
                               ("acc_grads", self.acc, acc)):
            if got.keys() != have.keys():
                missing = sorted(have.keys() ^ got.keys())
                raise KeyError(f"optimizer state {key}: names differ: {missing[:5]}")
        mini_step = int(state.get("mini_step", 0))
        if not 0 <= mini_step < self.k:
            raise ValueError(f"optimizer state mini_step {mini_step} with "
                             f"gradient_accumulation_steps {self.k}")
        for name, (mu, nu) in self.state.items():
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
        share = self.mesh is None or self.mesh.dp_index == 0
        for name, a in self.acc.items():
            if share:
                a.copy_(acc[name])
            else:
                a.zero_()
        self.count = int(state["count"])
        self.mini_step = mini_step

    @torch.no_grad()
    def step(self) -> None:
        """Take the parameters' .grad (None counts as zero) as one
        micro-batch's gradient: at k = 1 update at once; else fold it into
        the running mean and update from that at every k-th call."""
        def grads_of(named):
            return [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in named]

        if self.k == 1:
            self._update(grads_of)
            return
        n = self.mini_step + 1
        for group in self.schedules:
            named = self.groups[group]
            if named:
                # acc <- acc + (g - acc) / n, in MultiSteps' order
                accs = [self.acc[name] for name, _ in named]
                delta = torch._foreach_sub(grads_of(named), accs)
                torch._foreach_div_(delta, n)
                torch._foreach_add_(accs, delta)
        if n < self.k:
            self.mini_step = n
            return
        if self.mesh is not None:       # the ranks' shares of the mean, summed once
            sync_gradients(list(self.acc.values()), self.mesh)
        self._update(lambda named: [self.acc[name] for name, _ in named])
        for a in self.acc.values():
            a.zero_()
        self.mini_step = 0

    def _update(self, grads_of) -> None:
        """One clipped Adam update from grads_of(group's named parameters),
        each group's arithmetic in multi-tensor (torch._foreach_*) launches,
        in optax's operation order."""
        k = self.count + 1
        for group, schedule in self.schedules.items():
            named = self.groups[group]
            if not named:
                continue
            params = [p for _, p in named]
            device = params[0].device
            grads = grads_of(named)
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


def make_optimizer(model: nn.Module, cfg: Config, total_steps: int,
                   mesh: Optional[Mesh] = None) -> GroupedAdam:
    """total_steps: micro-batches over the run; the schedules' horizon is
    total_steps // gradient_accumulation_steps updates.  mesh: the ranks
    an accumulated update sums over."""
    return GroupedAdam(model, cfg, total_steps, mesh)
