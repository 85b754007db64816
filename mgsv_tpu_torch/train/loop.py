"""The training loop: epochs, evaluation, best-metric checkpoints, early
stop and step-granular resume; ported from mgsv_tpu/train/loop.py.

One Trainer replaces the reference's duplicated train-MaDe.py /
test-MaDe.py loops.  A step launches its work and returns: the loss is read
on the host only at the sampled NaN check (steps 1, 51, ...), at log points
and at checkpoints, and once per epoch for its statistics.  A step is one
micro-batch: with train.gradient_accumulation_steps = k the optimizer
updates every k-th.  train.device_data decides, as in JAX, whether the
datasets are made resident on the device (data/device_data.py) or fed by
the host pipeline.

Over a (dp, mp) mesh (core/mesh.py; one is made from train.mesh_shape
when the process is one rank of a torch.distributed group) every rank
trains on its dp index's rows of each global batch, takes the same update
and keeps the same weights (train/step.py), and evaluates its rows into
metrics every rank computes alike (eval/evaluator.py); the mp replicas of
a dp index repeat its work, as JAX's mesh does.  Only rank 0 writes
checkpoints, TensorBoard and history.json; every rank takes the snapshots
(a collective with gradient accumulation) and loads a resume point.  The
epoch's per-row aggregates are gathered over the dp group to every rank
(core/dist.py::to_host), and the ranks meet at a barrier at the end of
`fit`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import dist
from mgsv_tpu_torch.core.checkpoint import BestMetricTracker, CheckpointManager
from mgsv_tpu_torch.core.device import check_mesh_shape, resolve_device
from mgsv_tpu_torch.core.mesh import check_mesh, make_mesh
from mgsv_tpu_torch.core.profiling import StepProfiler
from mgsv_tpu_torch.data.dataset import MgsvDataset
from mgsv_tpu_torch.data.device_data import DeviceResidentData, use_device_data
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.optimizer import log_param_audit, make_optimizer
from mgsv_tpu_torch.train.step import make_eval_step, make_train_step

logger = logging.getLogger("mgsv_tpu_torch")

_TB_KEYS = ("loss", "retrieval_loss", "localization_loss", "loss_span", "loss_label",
            "loss_giou", "class_error", "loss_contrastive_align", "grad_norm")


class Preempted(RuntimeError):
    """Injected preemption (train.abort_at_step): the run dies at a chosen
    step, as a spot or maintenance kill would; resuming from the
    step-granular 'last' checkpoint replays to a bit-identical state."""


@dataclasses.dataclass
class EpochStats:
    loss: float
    retrieval_loss: float
    localization_loss: float
    miou: float
    seconds: float
    steps: int
    clips_per_sec: float


def _cpu_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class Trainer:
    def __init__(
        self,
        cfg: Config,
        train_data: Optional[MgsvDataset] = None,
        val_data: Optional[MgsvDataset] = None,
        mesh=None,
        run_dir: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        """device: where the model trains, a CUDA device unless the caller
        asks for the CPU.  Each evaluation runs `evaluate` as it defaults
        (the corpus similarity on kernel #4 on a CUDA device).  With
        train.device_data "on", or "auto" on a CUDA device with stores
        under the budget, the training data is made resident on the device,
        and the validation data too, sharing the copy when it is the same
        dataset.  mesh: a core.mesh.Mesh; None makes one from
        train.mesh_shape in a process group of several ranks, and runs one
        process alone otherwise.  Over a mesh the device is this rank's
        (core/dist.py::rank_device)."""
        check_mesh(mesh)
        if mesh is None and dist.process_count() > 1:
            mesh = make_mesh(cfg.train.mesh_shape)
        check_mesh_shape(cfg.train.mesh_shape, 1 if mesh is None else mesh.dp * mesh.mp)
        self.cfg = cfg
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        self.device = resolve_device(dist.rank_device(device))
        dp = 1 if mesh is None else mesh.dp
        if train_data is not None and use_device_data(cfg.train.device_data, self.device,
                                                      train_data, dp):
            resident = DeviceResidentData(train_data, self.device, mesh)
            logger.info("device-resident dataset enabled on %s%s", resident.device,
                        f" (tables split over {dp} ranks)" if mesh is not None else "")
            if val_data is not None:
                val_data = (resident if val_data is train_data
                            else DeviceResidentData(val_data, self.device, mesh))
            train_data = resident
        self.train_data = train_data
        self.val_data = val_data
        self.run_dir = run_dir or os.path.join(cfg.train.output_dir, cfg.train.name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.ckpt = CheckpointManager(self.run_dir) if cfg.train.save_checkpoints else None
        self.tracker = BestMetricTracker()
        steps_per_epoch = (train_data.num_batches(cfg.train.batch_size_train)
                           if train_data is not None else 1)
        self.total_steps = steps_per_epoch * cfg.train.epochs     # micro-batches
        self.model: Optional[MaDe] = None
        self.optimizer = None
        self.train_step = self.eval_step = None
        self.resume_step = 0
        self._saved_in_epoch = 0
        self._epoch_start_state = None
        self._tb = None

    # ------------------------------------------------------------------ state
    def init_state(self) -> MaDe:
        """Fresh weights from cfg.train.seed, the optimizer and the steps
        (the port's modules know their shapes from the config, so no
        example batch is needed)."""
        cfg = self.cfg
        self.model = MaDe(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(self.device)
        self.optimizer = make_optimizer(self.model, cfg, self.total_steps, self.mesh)
        self.train_step = make_train_step(self.model, cfg, self.optimizer, mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, cfg, mesh=self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("initialized %0.3fM trainable-head params on %s", n_params / 1e6,
                    self.device)
        log_param_audit(logger, self.model, train_query_embed=cfg.train.train_query_embed)
        return self.model

    @property
    def step(self) -> int:
        """Micro-batches applied so far (the JAX state's `step`)."""
        return self.optimizer.micro_step

    def _save(self, tag: str, state: Dict[str, Any]) -> None:
        """Write a checkpoint: rank 0 alone."""
        if self.primary:
            self.ckpt.save(tag, state)

    def _snapshot(self, epoch: int, with_opt: bool = True, **extra) -> Dict[str, Any]:
        """The state as CPU copies: {params, [opt_state,] step, epoch, ...};
        with the optimizer state a collective over a mesh (every rank takes
        it at the same point)."""
        state: Dict[str, Any] = {"params": _cpu_copy(self.model.state_dict())}
        if with_opt:
            state["opt_state"] = {k: _cpu_copy(v) if isinstance(v, dict) else v
                                  for k, v in self.optimizer.state_dict().items()}
        state.update(step=self.step, epoch=epoch, **extra)
        return state

    def _emergency_save(self, epoch: int) -> None:
        """Write the epoch-start snapshot as the resumable 'last' checkpoint
        after a non-finite loss: the live weights went through an update
        with NaN gradients.  A verified step-granular save of this epoch is
        newer and stays the resume point."""
        if self.ckpt is None:
            return
        if self._saved_in_epoch:
            logger.error("non-finite loss in epoch %d: resume point is the step-granular "
                         "'last' checkpoint (step_in_epoch %d, verified finite at save "
                         "time)", epoch, self._saved_in_epoch)
            return
        if self._epoch_start_state:
            self._save("last", self._epoch_start_state)
            logger.error("non-finite loss in epoch %d: emergency 'last' checkpoint written "
                         "from the epoch-start state (step %d)", epoch,
                         self._epoch_start_state["step"])

    def _periodic_save(self, epoch: int, steps: int, window) -> None:
        """Step-granular 'last' checkpoint (train.checkpoint_every_steps),
        written only after the losses since the previous save are verified
        finite, so a poisoned state never becomes the resume point.  Reading
        the window waits for the device."""
        vals = torch.stack(window).cpu().numpy().astype(np.float64)
        if not np.isfinite(vals).all():
            self._emergency_save(epoch)
            bad = int(np.argmax(~np.isfinite(vals)))
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} step {steps - len(vals) + bad + 1}: "
                f"{vals[bad]} (resumable 'last' checkpoint on disk; nothing poisoned "
                "was saved)")
        self._save("last", self._snapshot(epoch, step_in_epoch=steps))
        self._saved_in_epoch = steps

    def _tb_writer(self):
        """A tensorboardX writer into the run directory, when the package is
        installed, on rank 0; None otherwise."""
        if self._tb is None and not self.primary:
            self._tb = False
        if self._tb is None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                self._tb = False
            else:
                self._tb = SummaryWriter(log_dir=self.run_dir)
        return self._tb or None

    # ------------------------------------------------------------------ train
    def train_epoch(self, epoch: int, start_step: int = 0) -> EpochStats:
        """One epoch; `start_step` > 0 resumes mid-epoch: the seeded batch
        stream skips its first `start_step` batches, and the statistics
        cover the steps run here."""
        cfg = self.cfg
        if self.train_data is None:
            raise ValueError("train_epoch needs train_data")
        if self.model is None:
            self.init_state()
        batch_size = cfg.train.batch_size_train
        self._saved_in_epoch = 0
        if self.ckpt is not None:
            # clean state for the NaN guard; after a mid-epoch resume it is
            # the restored mid-epoch state
            self._epoch_start_state = (
                self._snapshot(epoch, step_in_epoch=start_step) if start_step
                else self._snapshot(epoch - 1))
        t0 = time.time()
        losses, ret_losses, loc_losses, ious = [], [], [], []
        steps = start_step
        every = cfg.train.checkpoint_every_steps
        log_every = max(1, self.train_data.num_batches(batch_size) // cfg.train.log_every)
        profiler = StepProfiler(self.run_dir, enabled=cfg.train.profile and epoch == 1)
        if isinstance(self.train_data, DeviceResidentData):
            stream = self.train_data.epoch_batches(batch_size, shuffle=True, seed=cfg.train.seed,
                                                   epoch=epoch, start_batch=start_step)
        else:
            stream = prefetch_epoch(self.train_data, batch_size, shuffle=True,
                                    device=self.device, seed=cfg.train.seed, epoch=epoch,
                                    start_batch=start_step, mesh=self.mesh)
        with contextlib.closing(stream) as batches:
            for batch, _meta in batches:
                profiler.step(steps)
                log = self.train_step(batch)
                steps += 1
                # sampled check: a non-finite loss poisons every later step
                if steps % 50 == 1 and not np.isfinite(float(log["loss"])):
                    self._emergency_save(epoch)
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch} step {steps}: "
                        f"{ {k: float(v) for k, v in log.items() if v.dim() == 0} }"
                        " (resumable 'last' checkpoint on disk: the epoch-start state, or "
                        "the newest verified step-granular save)")
                losses.append(log["loss"])
                ret_losses.append(log["retrieval_loss"])
                loc_losses.append(log["localization_loss"])
                ious.append(log["train_iou"])
                if every and self.ckpt is not None and steps % every == 0:
                    self._periodic_save(epoch, steps, losses[-every:])
                if cfg.train.abort_at_step and self.step >= cfg.train.abort_at_step:
                    raise Preempted(f"injected preemption at global step {self.step} "
                                    f"(epoch {epoch} step {steps})")
                if steps % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f (ret %.4f loc %.4f)", epoch, steps,
                                float(log["loss"]), float(log["retrieval_loss"]),
                                float(log["localization_loss"]))
                    tb = self._tb_writer()
                    if tb:
                        for key in _TB_KEYS:
                            if key in log:
                                tb.add_scalar(f"train/{key}", float(log[key]), self.step)
        profiler.close()
        # one wait for the device per epoch, and a check of every step's loss
        step_losses = (torch.stack(losses).cpu().numpy().astype(np.float64) if losses
                       else np.zeros(0))
        if not np.isfinite(step_losses).all():
            bad = int(np.argmax(~np.isfinite(step_losses)))
            self._emergency_save(epoch)
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} step {start_step + bad + 1}: "
                f"{step_losses[bad]} (resumable 'last' checkpoint on disk: the epoch-start "
                "state, or the newest verified step-granular save)")
        dt = time.time() - t0
        ran = steps - start_step
        if ran:
            loss = float(step_losses.mean())
            ret = float(torch.stack(ret_losses).cpu().numpy().astype(np.float64).mean())
            loc = float(torch.stack(loc_losses).cpu().numpy().astype(np.float64).mean())
            miou = float(np.mean(dist.to_host(
                torch.cat(ious), None if self.mesh is None else self.mesh.dp_group)))
        else:
            # eval-only replay: restore found the epoch trained but unrecorded
            loss = ret = loc = miou = float("nan")
        clips = ran * batch_size / dt if dt > 0 else 0.0
        stats = EpochStats(loss, ret, loc, miou, dt, ran, clips)
        tb = self._tb_writer()
        if tb:
            tb.add_scalar("train/loss_epoch", loss, epoch)
            tb.add_scalar("train/mIoU_epoch", miou, epoch)
            tb.add_scalar("train/clips_per_sec", clips, epoch)
        logger.info("epoch %d done: loss %.4f mIoU %.4f (%.1fs, %.1f clips/s)", epoch, loss,
                    miou, dt, clips)
        return stats

    # ------------------------------------------------------------------- eval
    def eval_epoch(self, epoch: int) -> Dict[str, Any]:
        if self.val_data is None or self.model is None:
            raise ValueError("eval_epoch needs val_data and an initialized model")
        res = evaluate(self.model, self.val_data, self.cfg, eval_step=self.eval_step,
                       mesh=self.mesh)
        r, l, c = res["retrieval"], res["localization"], res["composite"]
        logger.info(
            "eval %d >>> R@1 %.2f R@5 %.2f R@10 %.2f MdR %.1f MRR %.4f | "
            "mIoU %.4f IoU@.5 %.2f IoU@.7 %.2f | R1^iou.5 %.2f R1^iou.7 %.2f",
            epoch, r["R1"], r["R5"], r["R10"], r["MedianR"], r["MRR"],
            l["mIoU"], l["IoU@0.5"], l["IoU@0.7"], c["R1_iou0.5"], c["R1_iou0.7"])
        tb = self._tb_writer()
        if tb:
            tb.add_scalar("eval/R1_epoch", r["R1"], epoch)
            tb.add_scalar("eval/mIoU_epoch", l["mIoU"], epoch)
        return res

    # ----------------------------------------------------------------- resume
    def _history_has_epoch(self, epoch: int) -> bool:
        """Whether history.json (written atomically) records `epoch`."""
        try:
            with open(os.path.join(self.run_dir, "history.json")) as f:
                return any(int(r["epoch"]) == int(epoch) for r in json.load(f))
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, tag: str = "last") -> int:
        """Restore {params, opt_state, step, epoch[, step_in_epoch]} from a
        checkpoint; returns the epoch to resume from and sets
        `self.resume_step`.  An epoch-boundary checkpoint resumes at saved
        epoch + 1; a step-granular one resumes the same epoch past its
        completed steps; an epoch whose record never reached history.json
        (a kill during its evaluation) replays its evaluation only."""
        if self.ckpt is None or not self.ckpt.exists(tag):
            raise FileNotFoundError(f"no checkpoint {tag!r} under {self.run_dir}")
        if self.model is None:
            self.init_state()
        restored = self.ckpt.restore(tag)
        self.model.load_state_dict(restored["params"], strict=True)
        # best_*/epoch_* tags carry the weights only
        if "opt_state" in restored:
            self.optimizer.load_state_dict(restored["opt_state"])
        else:
            logger.warning("checkpoint %s has no optimizer state; resuming with a fresh "
                           "optimizer", tag)
        step = int(restored["step"])
        self.resume_step = int(restored.get("step_in_epoch", 0) or 0)
        saved_epoch = int(restored["epoch"])
        per_epoch = (self.train_data.num_batches(self.cfg.train.batch_size_train)
                     if self.train_data is not None else 0)
        if self.resume_step and self.train_data is not None and self.resume_step >= per_epoch:
            # saved at the epoch's final step: only its evaluation may be left
            if self._history_has_epoch(saved_epoch):
                self.resume_step = 0
                logger.info("restored %s at step %d (epoch %d complete)", tag, step,
                            saved_epoch)
                return saved_epoch + 1
            self.resume_step = per_epoch
            logger.info("restored %s at step %d: epoch %d train-complete but its record "
                        "never landed; replaying eval only", tag, step, saved_epoch)
            return saved_epoch
        if (not self.resume_step and saved_epoch >= 1 and self.train_data is not None
                and not self._history_has_epoch(saved_epoch)):
            self.resume_step = per_epoch
            logger.info("restored %s at step %d: epoch %d checkpointed but its record "
                        "never landed; replaying eval only", tag, step, saved_epoch)
            return saved_epoch
        if self.resume_step:
            logger.info("restored %s at step %d (epoch %d, mid-epoch at step %d)", tag, step,
                        saved_epoch, self.resume_step)
            return saved_epoch
        logger.info("restored %s at step %d (epoch %d)", tag, step, saved_epoch)
        return saved_epoch + 1

    # -------------------------------------------------------------------- fit
    def _write_history(self, history) -> None:
        """history.json through tmp + rename, on rank 0: a kill mid-write
        leaves the previous file whole."""
        if not self.primary:
            return
        path = os.path.join(self.run_dir, "history.json")
        with open(path + ".tmp", "w") as f:
            json.dump(history, f, indent=2, default=float)
        os.replace(path + ".tmp", path)

    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        epochs = epochs or cfg.train.epochs
        history = []
        start_epoch, resume_step = 1, 0
        hist_path = os.path.join(self.run_dir, "history.json")
        if cfg.train.resume and self.ckpt:
            if not self.ckpt.exists(cfg.train.resume):
                raise FileNotFoundError(
                    f"train.resume={cfg.train.resume!r} requested but no such checkpoint "
                    f"exists under {self.run_dir}; unset resume to train from scratch")
            start_epoch = self.restore(cfg.train.resume)
            resume_step = self.resume_step
            # continue the run's history (a mid-epoch resume redoes its
            # epoch's record)
            if os.path.exists(hist_path):
                with open(hist_path) as f:
                    history = [r for r in json.load(f) if r["epoch"] < start_epoch]
        if start_epoch > epochs:
            logger.info("resume epoch %d is beyond epochs=%d; nothing to do", start_epoch,
                        epochs)
            return {"history": history, "best": self.tracker.best}
        for epoch in range(start_epoch, epochs + 1):
            stats = self.train_epoch(epoch, start_step=resume_step if epoch == start_epoch
                                     else 0)
            record: Dict[str, Any] = {"epoch": epoch, "train": dataclasses.asdict(stats)}
            if self.val_data is not None:
                res = self.eval_epoch(epoch)
                flat = {**res["retrieval"], **res["localization"], **res["composite"]}
                flat.pop("cols", None)
                record["eval"] = flat
                improved = self.tracker.update(epoch, flat)
                if self.ckpt:
                    for tag in improved:
                        self._save(tag, self._snapshot(epoch, with_opt=False))
            if self.ckpt and cfg.train.save_every_epoch:
                self._save(f"epoch_{epoch}", self._snapshot(epoch, with_opt=False))
            if self.ckpt and cfg.train.checkpoint_every_steps:
                # epoch-boundary 'last': supersedes this epoch's mid-epoch save
                self._save("last", self._snapshot(epoch))
            history.append(record)
            self._write_history(history)
            if self.val_data is not None and self.tracker.should_stop(
                    epoch, cfg.train.early_stop_min_epochs, cfg.train.early_stop_patience):
                logger.info("early stop at epoch %d", epoch)
                break
        self._write_history(history)
        if self.ckpt:
            # "last" carries the optimizer state so training can resume
            self._save("last", self._snapshot(history[-1]["epoch"] if history else 0))
        if self.mesh is not None:
            dist.barrier("fit-end")
        return {"history": history, "best": self.tracker.best}
