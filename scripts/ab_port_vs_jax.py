"""Trained-behaviour A/B of the PyTorch port against the JAX package, on the CPU.

    python scripts/ab_port_vs_jax.py --dropout off
    python scripts/ab_port_vs_jax.py --dropout paper --ab-seeds 8
    python scripts/ab_port_vs_jax.py --dropout paper --seed-index 0,1 --records r0.jsonl
    python scripts/ab_port_vs_jax.py --stats-from r0.jsonl r1.jsonl

The twin of scripts/ab_trained_behavior.py, with the JAX package in the
reference's role: one synthetic store written by the port's
data/synthetic.py (its bytes are JAX's) and opened by both packages; one
init, JAX's Trainer.init_state, moved through interop/from_jax.py::
load_jax_params into the model of the port's Trainer.init_state (and the
port's optimizer checked to hold the loaded tensors); both Trainers read
epoch_batches(bs, shuffle=True, seed, epoch).  The shapes are the JAX A/B's
(`our_config`, ab_trained_behavior.py:129-143): the paper widths (D=256,
vit 512, ast 768, DETR 2 encoder / 6 decoder layers) at 10 frames and 12
snippets, float32, JAX's DETR encoder on its XLA path.

  --dropout off     every rate 0; 48 rows, bs 16, 20 epochs: each step's
                    loss through both packages' step functions (the
                    Trainers' steps, wrapped to record it) and both
                    Trainers' `fit` histories (each epoch's mean training
                    loss and evaluation metrics).  Held: each of the first
                    HELD_STEPS steps' losses within STEP_RTOL, relative;
                    the report names the first step over it.  Besides, at
                    every step of JAX's run a held step: JAX's parameters
                    and optimizer state before it moved into a third port
                    Trainer (interop/from_jax.py::load_jax_params and
                    jax_opt_state_to_port, through
                    scripts/convert_jax_run.py::opt_state_to_numpy), one
                    port step on JAX's batch, and its loss, gradients and
                    updated parameters held to JAX's step (`hold_step`).
  --dropout paper   the paper's rates: JAX's XLA dropout (its kernels' CPU
                    path) against the port's plain torch dropout (its fused
                    paths off, every mask from torch's generator), on a
                    confusable-family store (768 rows, bs 32, 10 epochs,
                    families of 32 at delta 0.15, the metrics averaged over
                    the last 4 evaluations).  The two sides of a seed share
                    one JAX init: paired seeds, compared by
                    scripts/ab_stats.py::compare_seeds (paired t, Welch,
                    Holm over the six metrics).  --seed-index runs a share
                    of the seeds into --records; --stats-from writes the
                    report from such records.

Each mode writes its section of --report (AB_PORT_REPORT.md), its decision
rule before its numbers, and its records as JSON under --out.  Extra
`--section.key value` pairs override both packages' configurations.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np
import torch

import ab_stats
from ab_kernels_cuda import first_over, flat_metrics, nudge_, optimizer_holds, recording
from chip_smoke import record_gates
from convert_jax_run import opt_state_to_numpy
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.core.mesh import make_mesh as jax_make_mesh
from mgsv_tpu.data.synthetic import open_synthetic as jax_open_synthetic
from mgsv_tpu.train.loop import Trainer as JaxTrainer
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import to_tensors
from mgsv_tpu_torch.interop.from_jax import (jax_opt_state_to_port, jax_variables_to_state_dict,
                                             load_jax_params)
from mgsv_tpu_torch.train.loop import Trainer
from mgsv_tpu_torch.train.optimizer import FROZEN, global_norm

SHAPES = {"data.max_v_frames": 10, "data.stride": 20.0, "data.filter_sec": 20.0,
          "model.compute_dtype": "float32", "model.fused_detr_encoder": False}
NO_DROPOUT = {"model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0,
              "model.detr_dropout": 0.0, "model.ca_dropout": 0.0}
PLAIN = {"model.fused_detr_encoder": False, "model.fused_xpool_sim": False,
         "model.fused_temporal": False}
# fixed before the run: the CPU holds the two packages' step losses to this
# (tests/test_torch_port_ab.py at small widths, the report at these)
STEP_RTOL = 1e-5
HELD_STEPS = 24
OFF_SEED = 42          # train.seed of --dropout off, scripts/ab_trained_behavior.py's
# a held step's rule, fixed before its first run: the loss within STEP_RTOL;
# the gradients within tests/test_torch_port_train.py's tolerances; each
# weight after the step within WEIGHT_ATOL of JAX's, or within 2 lr more
# where its clipped gradient lies within the gradient tolerance of zero
# (_assert_update there: such an element may take the other sign)
GRAD_ATOL, GRAD_RTOL, WEIGHT_ATOL = 1e-5, 1e-4, 1e-6
# a failed held step is taken again with the ReLU gates within GATE_EPS of
# zero (float32 rounding of an order-1 pre-activation) turned, singly, then
# in pairs among the first MAX_PAIR_GATES (hold_step)
GATE_EPS, MAX_PAIR_GATES = 1e-6, 12
SETUP_KEYS = ("rows", "epochs", "bs", "family_size", "family_delta", "eval_last_k")


def use_cpu_jax() -> None:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def configs(overrides: dict, port_extra: dict = None):
    """(the port's Config, JAX's Config) of the same overrides; the port's
    with `port_extra` on top."""
    return (Config.from_overrides({**overrides, **(port_extra or {})}),
            JaxConfig.from_overrides(overrides))


def paired_trainers(cfg: Config, jcfg: JaxConfig, root: str, workdir: str, jax_device=None):
    """JAX's Trainer and the port's (on the CPU) over the store at `root`
    (train and validation), both holding JAX's initial weights; JAX's on
    one device (`jax_device`, the first by default)."""
    jdata = jax_open_synthetic(root, jcfg.data)
    pdata = synthetic.open_synthetic(root, cfg.data)
    mesh = jax_make_mesh((1, 1), [jax_device or jax.devices()[0]])
    jt = JaxTrainer(jcfg, jdata, jdata, mesh=mesh, run_dir=os.path.join(workdir, "jax"))
    first = next(iter(jdata.epoch_batches(jcfg.train.batch_size_train, shuffle=False)))[0]
    jt.init_state(first)
    params = jax.device_get(jt.state.params)
    pt = Trainer(cfg, pdata, pdata, run_dir=os.path.join(workdir, "port"), device="cpu")
    pt.init_state()
    load_jax_params(pt.model, params, cfg)
    optimizer_holds(pt, {k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in jax_variables_to_state_dict(params, cfg).items()})
    return jt, pt


def record_steps(jt, pt):
    """Wrap both Trainers' steps; returns the lists their losses go to."""
    jax_losses, step = [], jt.train_step

    def jax_step(state, batch, rng):
        state, log = step(state, batch, rng)
        jax_losses.append(log["loss"])
        return state, log

    jt.train_step = jax_step
    return jax_losses, recording(pt)


def jax_grad_fn(model, jcfg: JaxConfig):
    """JAX's gradients of its training step's loss (mgsv_tpu/train/step.py::
    make_train_step's loss_fn) at a state's variables."""
    has_bn = jcfg.model.agg_module == "mlp"

    @jax.jit
    def grads(variables, batch, rng):
        def loss_fn(v):
            args = (batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                    batch["segment_mask"])
            kw = dict(v_duration=batch.get("v_duration"), deterministic=False,
                      rngs={"dropout": rng})
            out = (model.apply(v, *args, mutable=["batch_stats"], **kw)[0] if has_bn
                   else model.apply(v, *args, **kw))
            return jax_total_loss(out, batch["spans_target"], jcfg,
                                  music_codes=batch.get("music_codes"))[0]
        return jax.grad(loss_fn)(variables)

    return grads


def _worst(got: np.ndarray, want: np.ndarray, atol: float, rtol: float):
    """(largest |got - want|, elements outside atol + rtol |want|)."""
    err = np.abs(got - want)
    return float(err.max(initial=0.0)), int((err > atol + rtol * np.abs(want)).sum())


def _port_step(held: Trainer, cfg: Config, before: dict, batch: dict, jax_loss: float,
               grads, after: dict) -> dict:
    """JAX's state before its step k (`before`: {"params", "opt_state"},
    optax's objects) loaded into `held`, one port step on JAX's batch, and
    the step held to JAX's loss, gradients (`grads`) and state after the
    step (`after`).  The update's rule reads the gradient the update used
    (at k > 1 the running mean, from JAX's acc_grads), clipped per group."""
    load_jax_params(held.model, before["params"], cfg)
    opt = held.optimizer
    opt.load_state_dict(jax_opt_state_to_port(opt_state_to_numpy(before["opt_state"]), cfg))
    count, mini, acc = opt.count, opt.mini_step, {n: a.clone() for n, a in opt.acc.items()}
    log = held.train_step(to_tensors({k: np.asarray(v) for k, v in batch.items()}, "cpu"))
    rec = {"step": count * opt.k + mini + 1, "mini_step": mini,
           "loss_gap": abs(float(log["loss"]) - jax_loss) / abs(jax_loss)}
    want_g = jax_variables_to_state_dict(grads, cfg)
    got_after = {n: p.detach().numpy() for n, p in held.model.named_parameters()}
    want_after = jax_variables_to_state_dict(after["params"], cfg)
    start = jax_variables_to_state_dict(before["params"], cfg)
    worst = over = 0
    for name, p in held.model.named_parameters():
        g = np.zeros_like(want_g[name]) if p.grad is None else p.grad.numpy()
        w, o = _worst(g, want_g[name], GRAD_ATOL, GRAD_RTOL)
        worst, over = max(worst, w), over + o
    rec.update(grad_max_err=worst, grads_outside=over)
    updating = mini == opt.k - 1
    upd_err, slack, bad = 0.0, 0, 0
    rec["lr"] = {}
    for group, named in opt.groups.items():
        if group == FROZEN:
            for name, _ in named:
                bad += int((got_after[name] != start[name]).sum()
                           + (want_after[name] != start[name]).sum())
            continue
        if not named:
            continue
        used = {n: torch.from_numpy(np.asarray(want_g[n])) for n, _ in named}
        if opt.k > 1:                      # the running mean the update reads
            used = {n: acc[n] + (used[n] - acc[n]) / (mini + 1) for n in used}
        norm = float(global_norm(used.values()))
        clip = opt.max_norm / norm if norm >= opt.max_norm else 1.0
        lr = float(opt.schedules[group](count)) if updating else 0.0
        rec["lr"][group] = lr
        for name, _ in named:
            u = used[name].numpy()
            near_zero = np.abs(u * clip) <= clip * (GRAD_ATOL + GRAD_RTOL * np.abs(u))
            err = np.abs(got_after[name] - want_after[name])
            tol = WEIGHT_ATOL + np.where(near_zero, 2 * lr, 0.0)
            upd_err = max(upd_err, float(err.max(initial=0.0)))
            bad += int((err > tol).sum())
            slack += int((err > WEIGHT_ATOL).sum())
    rec.update(update_max_err=upd_err, updates_outside=bad, slack_elements=slack)
    if "batch_stats" in after["params"]:   # the EmbeddingNets' running buffers
        buffers = jax_variables_to_state_dict(after["params"], cfg)
        state = held.model.state_dict()
        rec["buffers_max_err"], rec["buffers_outside"] = max(
            (_worst(state[n].numpy(), buffers[n], GRAD_ATOL, GRAD_RTOL)
             for n in buffers if "running_" in n), default=(0.0, 0))
    if opt.k > 1 and not updating:         # the running mean after the step
        acc_after = jax_opt_state_to_port(opt_state_to_numpy(after["opt_state"]),
                                          cfg)["acc_grads"]
        rec["acc_max_err"], rec["acc_outside"] = max(
            (_worst(opt.acc[n].numpy(), acc_after[n].numpy(), GRAD_ATOL, GRAD_RTOL)
             for n in acc_after), default=(0.0, 0))
    rec["ok"] = bool(rec["loss_gap"] <= STEP_RTOL and over == 0 and bad == 0
                     and rec.get("buffers_outside", 0) == 0 and rec.get("acc_outside", 0) == 0)
    return rec


def flip_hooks(model, flips) -> list:
    """Forward hooks that turn the ReLU gates `flips` ((site, index) pairs
    at chip_smoke.py's RELU_SITES) to the other side of zero: the
    pre-activation is negated there, with a gradient of 1."""
    hooks = []
    for site, mod in model.named_modules():
        at = [idx for s, idx in flips if s == site]
        if at:
            def hook(m, i, o, at=at):
                mask = torch.zeros_like(o, dtype=torch.bool)
                for idx in at:
                    mask[idx] = True
                return torch.where(mask, o - 2 * o.detach(), o)
            hooks.append(mod.register_forward_hook(hook))
    return hooks


def hold_step(held: Trainer, cfg: Config, before: dict, batch: dict, jax_loss: float,
              grads, after: dict) -> dict:
    """One held step (`_port_step`).  Where it fails, the step again with
    the port's ReLU gates whose pre-activation lies within GATE_EPS of zero
    turned to the other side, one at a time, then two at a time, until the
    step holds: "gated" holds that step's comparisons and "gates_turned"
    the gates turned, with their pre-activations.  A gate at rounding
    distance from zero falls either way in a float32 run and moves a
    gradient by a whole term (PERF.md, PRs 1-17)."""
    pre: dict = {}
    hooks = record_gates(held.model, pre)
    try:
        rec = _port_step(held, cfg, before, batch, jax_loss, grads, after)
    finally:
        for h in hooks:
            h.remove()
    if rec["ok"]:
        return rec
    near = [(site, tuple(idx.tolist()), float(outs[0][tuple(idx)]))
            for site, outs in pre.items() for idx in (outs[0].abs() < GATE_EPS).nonzero()]
    rec["gates_near_zero"], rec["gates_turned"] = len(near), []
    subsets = itertools.chain(itertools.combinations(near, 1),
                              itertools.combinations(near[:MAX_PAIR_GATES], 2))
    for subset in subsets:
        hooks = flip_hooks(held.model, [(site, idx) for site, idx, _ in subset])
        try:
            rec["gated"] = _port_step(held, cfg, before, batch, jax_loss, grads, after)
        finally:
            for h in hooks:
                h.remove()
        if rec["gated"]["ok"]:
            rec["gates_turned"] = [list(g) for g in subset]
            break
    return rec


def held_steps(jt, held: Trainer, cfg: Config, jcfg: JaxConfig) -> List[dict]:
    """Wrap JAX's Trainer's step so that each of its steps is also held
    (`hold_step`) in `held`, a port Trainer of the same run; returns the
    list the records go to.  JAX's state is fetched before its step, which
    donates it."""
    records, step, grad_fn = [], jt.train_step, jax_grad_fn(jt.model, jcfg)

    def train_step(state, batch, rng):
        t0 = time.perf_counter()
        before = jax.device_get({"params": state.params, "opt_state": state.opt_state})
        grads = jax.device_get(grad_fn(state.params, batch, jax.random.fold_in(rng, state.step)))
        t1 = time.perf_counter()
        state, log = step(state, batch, rng)
        t2 = time.perf_counter()
        after = jax.device_get({"params": state.params, "opt_state": state.opt_state})
        rec = hold_step(held, cfg, before, jax.device_get(batch), float(log["loss"]), grads,
                        after)
        rec["seconds"] = time.perf_counter() - t2 + (t1 - t0)
        records.append(rec)
        return state, log

    jt.train_step = train_step
    return records


def step_gaps(jax_losses: Sequence, port_losses: Sequence) -> np.ndarray:
    j = np.asarray([float(x) for x in jax_losses], np.float64)
    p = np.asarray([float(x) for x in port_losses], np.float64)
    if len(j) != len(p):
        raise AssertionError(f"{len(j)} JAX steps against {len(p)} of the port")
    return np.abs(p - j) / np.abs(j)


def make_store(root: str, cfg: Config, a, family: bool) -> str:
    synthetic.generate(root, n_rows=a.rows, n_unique_music=max(2, a.rows // 2),
                       data_cfg=cfg.data, seed=0,
                       **({"family_size": a.family_size, "family_delta": a.family_delta}
                          if family else {}))
    return root


def base_overrides(a) -> dict:
    return {**SHAPES, "train.batch_size_train": a.bs, "train.batch_size_val": a.bs,
            "train.epochs": a.epochs, "train.save_checkpoints": False, **a.overrides}


# ---------------------------------------------------------------- dropout off
def run_off(a, workdir: str) -> dict:
    cfg, jcfg = configs({**base_overrides(a), **NO_DROPOUT, "train.seed": OFF_SEED})
    root = make_store(os.path.join(workdir, "data"), cfg, a, family=False)
    jt, pt = paired_trainers(cfg, jcfg, root, workdir)
    jt_init = jax.device_get(jt.state.params)
    jax_losses, port_losses = record_steps(jt, pt)
    held = Trainer(cfg, pt.train_data, None, run_dir=os.path.join(workdir, "held"),
                   device="cpu")
    held.init_state()
    held_recs = held_steps(jt, held, cfg, jcfg)
    t0 = time.perf_counter()
    jax_fit = jt.fit()
    t1 = time.perf_counter()
    held_seconds = sum(r["seconds"] for r in held_recs)
    port_fit = pt.fit()
    t2 = time.perf_counter()
    gaps = step_gaps(jax_losses, port_losses)
    # control: the port against itself from JAX's init moved by one ulp
    control = Trainer(cfg, pt.train_data, None, run_dir=os.path.join(workdir, "control"),
                      device="cpu")
    control.init_state()
    load_jax_params(control.model, jax.device_get(jt_init), cfg)
    nudge_(control.model)
    control_losses = recording(control)
    for epoch in range(1, a.epochs + 1):
        control.train_epoch(epoch)
    control_gaps = step_gaps(port_losses, control_losses)
    history = []
    for jr, pr in zip(jax_fit["history"], port_fit["history"]):
        rec = {"epoch": jr["epoch"], "jax_loss": jr["train"]["loss"],
               "port_loss": pr["train"]["loss"]}
        for k in ab_stats.METRICS:
            rec[f"jax_{k}"], rec[f"port_{k}"] = jr["eval"][k], pr["eval"][k]
        history.append(rec)
    return {"steps": len(gaps), "step_gaps": gaps.tolist(),
            "jax_losses": [float(x) for x in jax_losses],
            "port_losses": [float(x) for x in port_losses],
            "first_over": first_over(gaps, STEP_RTOL),
            "control_gaps": control_gaps.tolist(),
            "control_first_over": first_over(control_gaps, STEP_RTOL),
            "held": bool((gaps[:HELD_STEPS] <= STEP_RTOL).all()),
            "held_steps": held_recs, "held_steps_ok": all(map(held_ok, held_recs)),
            "history": history, "jax_seconds": t1 - t0 - held_seconds,
            "held_seconds": held_seconds, "port_seconds": t2 - t1}


def held_ok(rec: dict) -> bool:
    """A held step holds as the rule is written, or with gates at rounding
    distance from zero turned (`hold_step`)."""
    return rec["ok"] or rec.get("gated", {}).get("ok", False)


def held_rule() -> str:
    return (f"Held steps (rule fixed before their first run): at every step of JAX's run, "
            "JAX's parameters and optimizer state before it are loaded into a port Trainer "
            "(`load_jax_params`, `jax_opt_state_to_port`) and the port takes one step on "
            f"JAX's batch.  It holds when the loss is within {STEP_RTOL:g} of JAX's, "
            f"relative; every gradient element within {GRAD_ATOL:g} + {GRAD_RTOL:g} x |JAX's| "
            "(tests/test_torch_port_train.py's tolerances); and every parameter after the "
            f"step within {WEIGHT_ATOL:g} of JAX's, or within 2 lr more where the clipped "
            "gradient the update read lies within the gradient tolerance of zero (such an "
            "element may move the other way in either package); the slack column counts "
            f"the elements further than {WEIGHT_ATOL:g} from JAX's.  Added after the "
            "rule failed at four steps: a failed step is taken again with the port's ReLU "
            f"gates whose pre-activation lies within {GATE_EPS:g} of zero (rounding "
            "distance) turned to the other side, one at a time, then two at a time, until "
            "it holds; the last column gives the gates so turned and that step's errors "
            "under the same rule.")


def held_table(recs: List[dict]) -> List[str]:
    lines = ["| step | lr | loss gap | grad max err | grads outside | update max err "
             "| updates outside | slack elements | held | gates turned (pre-activation): grad max "
             "err, update max err, held |", "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        lr = max(r["lr"].values(), default=0.0)
        g = r.get("gated")
        turned = "; ".join(f"{site}{tuple(idx)} ({v:.1e})" for site, idx, v in
                           r.get("gates_turned", []))
        gated = ("-" if g is None else
                 f"{turned or 'none of ' + str(r['gates_near_zero'])}: "
                 f"{g['grad_max_err']:.2e}, {g['update_max_err']:.2e}, "
                 f"{'yes' if g['ok'] else '**no**'}")
        lines.append(f"| {r['step']} | {lr:.3e} | {r['loss_gap']:.2e} | {r['grad_max_err']:.2e} "
                     f"| {r['grads_outside']} | {r['update_max_err']:.2e} "
                     f"| {r['updates_outside']} | {r['slack_elements']} "
                     f"| {'yes' if r['ok'] else '**no**'} | {gated} |")
    return lines


def off_section(res: dict, a) -> List[str]:
    steps_per_epoch = a.rows // a.bs
    final = [r if r["ok"] or "gated" not in r else r["gated"] for r in res["held_steps"]]
    lines = [
        f"Generated by `scripts/ab_port_vs_jax.py --dropout off --rows {a.rows} --bs {a.bs} "
        f"--epochs {a.epochs}` on the CPU ({a.rows} rows, {a.rows // 2} tracks, "
        f"{steps_per_epoch} steps an epoch, {res['steps']} steps; float32, 10 frames, "
        "12 snippets, D=256, DETR 2 / 6 layers).",
        "",
        f"Decision rule (fixed before the run): the two packages compute the same "
        f"training when each of the first {HELD_STEPS} steps' losses agree within "
        f"{STEP_RTOL:g}, relative.  Past the first step over that bound, rounding in "
        "other summation orders grows from step to step (AB_REPORT.md saw the same "
        "between JAX and the reference), and the table shows how far the runs drift.  "
        "The control is the port against itself from JAX's init moved by one float32 "
        "ulp: how fast this training amplifies a rounding difference.",
        "",
        f"- largest relative step gap over the first {HELD_STEPS} steps: "
        f"{max(res['step_gaps'][:HELD_STEPS]):.3e}; over all {res['steps']} steps: "
        f"{max(res['step_gaps']):.3e}",
        f"- first step whose relative gap exceeds {STEP_RTOL:g}: "
        f"{res['first_over'] or 'none'}; the control's: {res['control_first_over'] or 'none'}",
        "- relative gap at steps 1-12, port against JAX: "
        + " ".join(f"{g:.1e}" for g in res["step_gaps"][:12])
        + "; control: " + " ".join(f"{g:.1e}" for g in res["control_gaps"][:12]),
        f"- verdict: **{'held' if res['held'] else 'FAILED'}**; seconds: JAX "
        f"{res['jax_seconds']:.1f}, port {res['port_seconds']:.1f}",
        "",
        held_rule(),
        "",
        f"- held steps: **{sum(r['ok'] for r in res['held_steps'])} of "
        f"{len(res['held_steps'])} held as the rule is written, "
        f"{sum(map(held_ok, res['held_steps']))} with gates at rounding distance turned** "
        f"({sum(len(r.get('gates_turned', [])) for r in res['held_steps'])} gates turned in "
        "all); over the holding steps (a turned step's second run), the largest loss gap "
        f"{max(r['loss_gap'] for r in final):.3e}, gradient error "
        f"{max(r['grad_max_err'] for r in final):.3e}, update error "
        f"{max(r['update_max_err'] for r in final):.3e}, elements on the slack "
        f"{sum(r['slack_elements'] for r in final)} in all; {res['held_seconds']:.1f} s",
        "",
    ] + held_table(res["held_steps"]) + [
        "",
        "| epoch | loss (JAX) | loss (port) | R@1 JAX/port | R@10 JAX/port "
        "| mIoU JAX/port | IoU@0.5 JAX/port |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in res["history"]:
        lines.append(
            f"| {r['epoch']} | {r['jax_loss']:.6f} | {r['port_loss']:.6f} "
            f"| {r['jax_R1']:.1f} / {r['port_R1']:.1f} | {r['jax_R10']:.1f} / "
            f"{r['port_R10']:.1f} | {r['jax_mIoU']:.4f} / {r['port_mIoU']:.4f} "
            f"| {r['jax_IoU@0.5']:.2f} / {r['port_IoU@0.5']:.2f} |")
    lines.append("")
    return lines


# -------------------------------------------------------------- dropout paper
def run_seed(a, seed: int, root: str, workdir: str) -> dict:
    """One paired seed: JAX's Trainer and the port's from JAX's init for
    `seed`, a.epochs epochs each, the metrics averaged over the last
    a.eval_last_k evaluations."""
    cfg, jcfg = configs({**base_overrides(a), "train.seed": seed}, PLAIN)
    jt, pt = paired_trainers(cfg, jcfg, root, os.path.join(workdir, f"seed{seed}"))
    rec = {"seed": seed, "setup": setup(a), "seconds": {}, "per_epoch": {}}
    for side, trainer in (("jax", jt), ("port", pt)):
        t0 = time.perf_counter()
        evals = []
        for epoch in range(1, a.epochs + 1):
            trainer.train_epoch(epoch)
            if epoch > a.epochs - a.eval_last_k:
                evals.append(flat_metrics(trainer.eval_epoch(epoch)))
        rec["seconds"][side] = time.perf_counter() - t0
        for k in ab_stats.METRICS:
            rec[f"{side}_{k}"] = float(np.mean([m[k] for m in evals]))
        rec["per_epoch"][side] = {k: [m[k] for m in evals] for k in ab_stats.METRICS}
    return rec


def setup(a) -> dict:
    return {**{k: getattr(a, k) for k in SETUP_KEYS}, "overrides": a.overrides}


def load_records(paths: Sequence[str]) -> List[dict]:
    """Per-seed records of --records files, one setup, sorted by seed; a
    seed recorded twice must have the same metrics."""
    by_seed: Dict[int, dict] = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                old = by_seed.setdefault(rec["seed"], rec)
                if any(old[f"{s}_{k}"] != rec[f"{s}_{k}"]
                       for s in ("jax", "port") for k in ab_stats.METRICS):
                    raise ValueError(f"seed {rec['seed']} recorded twice with other metrics")
    records = [by_seed[s] for s in sorted(by_seed)]
    setups = {json.dumps(r["setup"], sort_keys=True) for r in records}
    if len(setups) > 1:
        raise ValueError(f"records of {len(setups)} setups: {sorted(setups)}")
    return records


def paper_section(records: List[dict]) -> List[str]:
    """The dropout-on section; its seed count and setup come from `records`."""
    s = records[0]["setup"]
    n = len(records)
    stats = ab_stats.compare_seeds(records, s["rows"], s["eval_last_k"], a="jax", b="port")
    flagged = [k for k, v in stats.items() if not v["compatible"]]
    secs = {side: sum(r["seconds"][side] for r in records) for side in ("jax", "port")}
    return [
        f"Generated by `scripts/ab_port_vs_jax.py --dropout paper --epochs {s['epochs']} "
        f"--rows {s['rows']} --bs {s['bs']} --family-size {s['family_size']} "
        f"--family-delta {s['family_delta']} --eval-last-k {s['eval_last_k']}` on the CPU "
        f"over {n} paired seeds ({', '.join(str(r['seed']) for r in records)}).  JAX "
        "trains with its XLA dropout, the port with its plain torch dropout, both at "
        "the paper's rates (temporal 0.8, X-Pool 0.3, DETR 0.1), each side from the "
        "seed's JAX init.",
        "",
    ] + ab_stats.seed_rule(s["rows"], s["eval_last_k"]) + [""] + ab_stats.seed_table(
        stats, "jax", "port", "JAX", "port") + [
        "",
        f"Per metric compatible: **{not flagged}**"
        + (f" (outside their MDE: {', '.join(flagged)})" if flagged else "")
        + f"; family-wise (Holm, 6 metrics, FWER 5%): "
        f"**{'clean' if ab_stats.family_clean(stats) else 'REJECTED'}**.  Training and "
        f"evaluation seconds summed over the seeds: JAX {secs['jax']:.0f}, port "
        f"{secs['port']:.0f}.",
        "",
    ]


PAPER_HEADING = "Port against JAX on the CPU: dropout on, paired seeds"
OFF_HEADING = "Port against JAX on the CPU: dropout off"


# ----------------------------------------------------------------------- main
def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dropout", choices=["off", "paper"], default="off")
    p.add_argument("--rows", type=int, default=None, help="48 off, 768 paper")
    p.add_argument("--bs", type=int, default=None, help="16 off, 32 paper")
    p.add_argument("--epochs", type=int, default=None, help="20 off, 10 paper")
    p.add_argument("--ab-seeds", type=int, default=8)
    p.add_argument("--seed-index", default=None,
                   help="comma-separated indices i of seeds 1000 + 13 i to run")
    p.add_argument("--family-size", type=int, default=32)
    p.add_argument("--family-delta", type=float, default=0.15)
    p.add_argument("--eval-last-k", type=int, default=4)
    p.add_argument("--records", default=None, help="JSONL the paper mode appends seeds to")
    p.add_argument("--stats-from", nargs="+", default=None)
    p.add_argument("--report", default="AB_PORT_REPORT.md")
    p.add_argument("--out", default=os.path.join("build", "ab"))
    a, rest = p.parse_known_args(argv)
    a.overrides = parse_kv_overrides(rest)
    off = a.dropout == "off"
    a.rows = a.rows or (48 if off else 768)
    a.bs = a.bs or (16 if off else 32)
    a.epochs = a.epochs or (20 if off else 10)
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    use_cpu_jax()
    os.makedirs(a.out, exist_ok=True)
    if a.stats_from:
        ab_stats.write_section(a.report, PAPER_HEADING, paper_section(load_records(a.stats_from)))
        return 0
    with tempfile.TemporaryDirectory() as workdir:
        if a.dropout == "off":
            res = run_off(a, workdir)
            ab_stats.write_section(a.report, OFF_HEADING, off_section(res, a))
            with open(os.path.join(a.out, "ab_port_vs_jax_off.json"), "w") as f:
                json.dump(res, f, indent=1)
            print(json.dumps({k: res[k] for k in ("steps", "first_over", "held",
                                                  "held_steps_ok")}))
            return 0 if res["held_steps_ok"] else 1
        indices = ([int(i) for i in a.seed_index.split(",")] if a.seed_index
                   else range(a.ab_seeds))
        cfg, _ = configs(base_overrides(a), PLAIN)
        root = make_store(os.path.join(workdir, "data"), cfg, a, family=True)
        path = a.records or os.path.join(a.out, "ab_port_vs_jax_paper.jsonl")
        for i in indices:
            rec = run_seed(a, 1000 + 13 * i, root, workdir)
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps({k: v for k, v in rec.items() if k != "per_epoch"}), flush=True)
        if a.seed_index is None:
            ab_stats.write_section(a.report, PAPER_HEADING, paper_section(load_records([path])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
