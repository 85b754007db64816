"""Trained-behaviour A/B of the port's kernel path against its plain path.

    python3 scripts/ab_kernels_cuda.py --dropout off
    python3 scripts/ab_kernels_cuda.py --dropout paper --ab-seeds 24
    python3 scripts/ab_kernels_cuda.py --fingerprint --draws 300

Three arms of one configuration, each trained by the port's own Trainer
(train/loop.py) and step (train/step.py) on the card, at the paper's width
and length (50 frames x 512, 96 snippets x 768, D=256, DETR 2 encoder / 6
decoder layers) on a confusable-family store of data/synthetic.py:

  kernels           Config() as the main path trains it: bf16, the DETR
                    encoder on #1/#2 (precision "bf16", dropout 0.1), the
                    training X-Pool similarity on #3 (float32, dropout 0.3)
  kernels_temporal  the same with model.fused_temporal: both temporal towers
                    on #5 (float32, dropout 0.8)
  plain             the same with fused_detr_encoder, fused_xpool_sim and
                    fused_temporal off: every mask from torch's generator
                    (train/step.py::step_generator)

Every arm evaluates through the default evaluator (#4 on the card), so the
arms differ only in how they train.  Each kernel arm's launches of #1, #2,
#3 and #5 are read, so an arm that ran plain is caught.  The arms of a seed
start from one set of weights (the plain arm's init, loaded into the others).

  --dropout off   float32, every rate 0: at each of the plain arm's first
                  --steps (24) steps, each kernel arm steps from the plain
                  arm's weights and optimizer state on the same batch, its
                  loss within OFF_RTOL and its gradient norm within
                  GRAD_NORM_RTOL of plain's; the free-running trajectories
                  are reported beside a control (the plain arm from its
                  init moved by one float32 ulp).
  --dropout paper --ab-seeds N paired seeds (768 rows, bs 32, 10 epochs,
                  the metrics averaged over the last 4): each kernel arm
                  against plain by scripts/ab_stats.py::compare_seeds.
  --fingerprint   one set of weights, one 64-row batch, dropout on in one
                  subsystem at a time (none, temporal, xpool, detr, all);
                  the retrieval and localization losses over --draws mask
                  draws of each kernel arm against plain's: means (z) and
                  spreads (Brown-Forsythe, F-ratio), Holm over each arm's
                  comparisons; "none" within NONE_RTOL.  float32, so #1
                  runs at precision "f32" here (its bf16 instantiation
                  draws the same Philox masks and trains in --dropout paper).
  --stats-from R  --dropout paper's section from its records (the JSONL it
                  writes under --out) alone, without a device.

Each mode writes its section of --report (AB_PORT_REPORT.md) with its
decision rule before its numbers and the card's name and power limit
(nvidia-smi) beside them, and a JSON of its records under --out.  Extra
`--section.key value` pairs override the configuration (the tests run
--device cpu at tiny widths; on the CPU the kernel wrappers run their plain
versions with the same Philox masks and launch nothing).  Exits non-zero
when a check fails.  Imports nothing of JAX or of mgsv_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

import ab_stats
from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import to_tensors
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.train.loop import Trainer
from mgsv_tpu_torch.train.objective import total_loss
from mgsv_tpu_torch.train.step import step_generator

ARMS = {
    "kernels": {},
    "kernels_temporal": {"model.fused_temporal": True},
    "plain": {"model.fused_detr_encoder": False, "model.fused_xpool_sim": False,
              "model.fused_temporal": False},
}
KERNEL_ARMS = ("kernels", "kernels_temporal")
# The training kernels of the path (#1, #2, #3, #5) and the evaluation's #4,
# by their wrappers' counters
COUNTERS = {"fused_encoder_layer": (fel, "fused_encoder_layer"),
            "fused_encoder_layer_bwd": (fel, "fused_encoder_layer_bwd"),
            "xpool_sim_fwd": (xps, "xpool_sim_fwd"), "xpool_sim_bwd": (xps, "xpool_sim_bwd"),
            "fused_temporal_layer": (ftl, "fused_temporal_layer"),
            "fused_temporal_layer_bwd": (ftl, "fused_temporal_layer_bwd"),
            "xpool_sim_eval": (xps, "xpool_sim_eval")}
_BACKWARD = {"fused_encoder_layer": "fused_encoder_layer_bwd", "xpool_sim_fwd": "xpool_sim_bwd",
             "fused_temporal_layer": "fused_temporal_layer_bwd"}
RATES = {"temporal": {"model.temporal_dropout": 0.8}, "xpool": {"model.xpool_dropout": 0.3},
         "detr": {"model.detr_dropout": 0.1}}
NO_DROPOUT = {"model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0,
              "model.detr_dropout": 0.0, "model.ca_dropout": 0.0}
FLOAT32_NO_DROPOUT = {"model.compute_dtype": "float32", **NO_DROPOUT}
SCENARIOS = {"none": (), "temporal": ("temporal",), "xpool": ("xpool",),
             "detr": ("detr",), "all": ("temporal", "xpool", "detr")}
COMPONENTS = ("retrieval_loss", "localization_loss")
SETUP_KEYS = ("rows", "epochs", "bs", "eval_last_k", "overrides")
# the store of scripts/ab_trained_behavior.py's dropout A/B (AB_REPORT.md:102):
# families of 32 confusable tracks, 0.15 apart; the seeds and seed of the
# fixed-seed modes are that script's
FAMILY_SIZE, FAMILY_DELTA = 32, 0.15
FIRST_SEED, SEED = 1000, 1000
PAPER_HEADING = "Kernel path against plain path: dropout on, paired seeds"
# Bounds fixed before the first run on the card.  OFF_RTOL: a kernel arm's
# loss at each of the first 24 float32 steps at rate 0, taken from the plain
# arm's weights and optimizer state at that step, relative to plain's; the
# CPU holds the port to JAX at 1e-5, and the card's kernels take their
# products in 3xTF32 and sum in other orders.  GRAD_NORM_RTOL: the same
# steps' gradient norms.  Free-running trajectories are reported beside a
# control and bound nothing: at these widths the plain arm against itself
# from weights one float32 ulp apart leaves 1e-4 by step 9 (a CPU run).
# NONE_RTOL: the fingerprint's "none" scenario, one float32 forward of each
# arm from the same weights.
OFF_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
NONE_RTOL = 1e-4
NONE_DRAWS = 3


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, a line that says so."""
    if device.type != "cuda":
        return "cpu (no card; the kernel wrappers run their plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def read_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr).launches for name, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        getattr(mod, attr).launches = 0


def check_launches(arm: str, counts: Dict[str, int], device: torch.device,
                   backward: bool = True, evaluated: bool = False) -> None:
    """Raise unless `arm` launched its kernels: on the card #1 and #3 (and
    #5 in kernels_temporal), with `backward` their backwards, with
    `evaluated` #4; nothing else of #1-#3, #5; on the CPU nothing at all."""
    want = set()
    if device.type == "cuda":
        if arm != "plain":
            want |= {"fused_encoder_layer", "xpool_sim_fwd"}
            if arm == "kernels_temporal":
                want.add("fused_temporal_layer")
        if backward:
            want |= {_BACKWARD[n] for n in want}
        if evaluated:
            want.add("xpool_sim_eval")
    wrong = {n: c for n, c in counts.items() if (c > 0) != (n in want)}
    if wrong:
        raise AssertionError(f"{arm}: launches {counts}, expected launches of exactly "
                             f"{sorted(want)}")


def arm_config(arm: str, overrides: dict) -> Config:
    return Config.from_overrides({**overrides, **ARMS[arm]})


def base_overrides(a, fixed: Optional[dict] = None) -> dict:
    """The configuration every arm shares: the run's batch and epochs, no
    checkpoints, the `--section.key value` overrides, then `fixed` (the
    float32 modes' dtype and rates)."""
    return {"train.batch_size_train": a.bs, "train.epochs": a.epochs,
            "train.save_checkpoints": False, **a.overrides, **(fixed or {})}


def make_store(root: str, cfg: Config, rows: int, a) -> str:
    synthetic.generate(root, n_rows=rows, n_unique_music=max(2, rows // 2), data_cfg=cfg.data,
                       seed=0, family_size=FAMILY_SIZE, family_delta=FAMILY_DELTA)
    return root


def optimizer_holds(trainer, want: Dict[str, torch.Tensor]) -> None:
    """Raise unless the trainer's optimizer updates the model's own
    parameters and they equal `want` (a loaded state dict)."""
    held = {n: p for group in trainer.optimizer.groups.values() for n, p in group}
    live = dict(trainer.model.named_parameters())
    if held.keys() != live.keys():
        raise AssertionError("the optimizer's parameters are not the model's")
    for name, p in held.items():
        if p is not live[name] or not torch.equal(p.detach().cpu(), want[name].cpu()):
            raise AssertionError(f"the optimizer does not hold the loaded {name}")


def start(cfg: Config, data, device: torch.device, run_dir: str,
          init: Optional[Dict[str, torch.Tensor]] = None) -> Trainer:
    """A Trainer of `cfg` on `data` (train and validation), its state made,
    `init` loaded into its model where given."""
    trainer = Trainer(cfg, train_data=data, val_data=data, run_dir=run_dir, device=device)
    trainer.init_state()
    if init is not None:
        trainer.model.load_state_dict(init, strict=True)
        optimizer_holds(trainer, init)
    return trainer


def recording(trainer) -> List[torch.Tensor]:
    """Wrap the trainer's step so that each step's loss is appended to the
    returned list."""
    losses, step = [], trainer.train_step

    def train_step(batch):
        log = step(batch)
        losses.append(log["loss"].detach())
        return log

    trainer.train_step = train_step
    return losses


def init_state(cfg: Config) -> Dict[str, torch.Tensor]:
    """The plain arm's initial weights for cfg.train.seed (on the CPU)."""
    model = MaDe(cfg, torch.Generator().manual_seed(cfg.train.seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def flat_metrics(res: dict) -> Dict[str, float]:
    flat = {**res["retrieval"], **res["localization"]}
    return {k: float(flat[k]) for k in ab_stats.METRICS}


# ---------------------------------------------------------------- dropout off
def nudge_(model: torch.nn.Module) -> None:
    """Move every parameter one float32 ulp up: the control of a
    free-running comparison."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))


def first_over(rel: np.ndarray, bound: float) -> Optional[int]:
    """The first step (from 1) whose relative gap exceeds `bound`, or None."""
    over = np.flatnonzero(~(rel <= bound))
    return int(over[0]) + 1 if len(over) else None


def batch_stream(data, bs: int, seed: int, device: torch.device):
    """The training batches of epochs 1, 2, ... as the Trainer orders them."""
    epoch = 1
    while True:
        for batch, _ in data.epoch_batches(bs, shuffle=True, seed=seed, epoch=epoch):
            yield to_tensors(batch, device)
        epoch += 1


def run_off(a, device: torch.device, data_root: str, workdir: str) -> dict:
    """float32 at rate 0, the first a.steps steps.  Held: each step of each
    kernel arm taken from the plain arm's weights and optimizer state at
    that step, on the same batch: its loss within OFF_RTOL and its gradient
    norm within GRAD_NORM_RTOL of plain's.  Reported: each arm's free-running
    trajectory through Trainer.train_epoch, its launches, and the plain arm
    from its init moved by one ulp ("control")."""
    over = base_overrides(a, FLOAT32_NO_DROPOUT)
    plain_cfg = arm_config("plain", over)
    data = synthetic.open_synthetic(data_root, plain_cfg.data)
    init = init_state(plain_cfg)
    trainers = {arm: start(arm_config(arm, over), data, device,
                           os.path.join(workdir, f"forced_{arm}"), init) for arm in ARMS}
    plain = trainers["plain"]
    forced = {arm: {"loss": [], "grad_norm": []} for arm in ARMS}
    reset_counts()
    stream = batch_stream(data, a.bs, plain_cfg.train.seed, device)
    for _ in range(a.steps):
        batch = next(stream)
        for arm in KERNEL_ARMS:
            trainers[arm].model.load_state_dict(plain.model.state_dict())
            trainers[arm].optimizer.load_state_dict(plain.optimizer.state_dict())
        for arm in ARMS:          # plain last: it moves the state the others start from
            log = trainers[arm].train_step(batch)
            for key in ("loss", "grad_norm"):
                forced[arm][key].append(log[key].detach())
    forced_launches = read_counts()
    del trainers, plain
    free(device)
    forced = {arm: {k: np.asarray([float(x) for x in torch.stack(v).cpu()], np.float64)
                    for k, v in logs.items()} for arm, logs in forced.items()}

    per_epoch = data.num_batches(a.bs)
    losses, launches, seconds = {}, {}, {}
    for arm in (*ARMS, "control"):
        trainer = start(arm_config("plain" if arm == "control" else arm, over), data, device,
                        os.path.join(workdir, f"free_{arm}"), init)
        if arm == "control":
            nudge_(trainer.model)
        got = recording(trainer)
        reset_counts()
        t0 = time.perf_counter()
        for epoch in range(1, -(-a.steps // per_epoch) + 1):
            trainer.train_epoch(epoch)
        seconds[arm] = time.perf_counter() - t0
        launches[arm] = read_counts()
        check_launches("plain" if arm == "control" else arm, launches[arm], device)
        losses[arm] = np.asarray([float(x) for x in torch.stack(got[:a.steps]).cpu()],
                                 np.float64)
        del trainer, got
        free(device)
    if not (np.isfinite(forced["plain"]["loss"]).all() and np.isfinite(losses["plain"]).all()):
        raise AssertionError(f"plain arm: losses {forced['plain']['loss']}, {losses['plain']}")
    result = {"steps": a.steps, "rtol": OFF_RTOL, "grad_norm_rtol": GRAD_NORM_RTOL,
              "forced": {arm: {k: v.tolist() for k, v in f.items()} for arm, f in forced.items()},
              "forced_launches": forced_launches,
              "free_losses": {arm: v.tolist() for arm, v in losses.items()},
              "launches": launches, "seconds": seconds, "arms": {}}
    for arm in (*KERNEL_ARMS, "control"):
        free_rel = np.abs(losses[arm] - losses["plain"]) / np.abs(losses["plain"])
        row = {"free_max_rel": float(free_rel.max()),
               "free_first_over": first_over(free_rel, OFF_RTOL)}
        if arm != "control":
            f, p = forced[arm], forced["plain"]
            loss_rel = np.abs(f["loss"] - p["loss"]) / np.abs(p["loss"])
            norm_rel = np.abs(f["grad_norm"] - p["grad_norm"]) / np.abs(p["grad_norm"])
            row.update(max_rel=float(loss_rel.max()), step_of_max=int(loss_rel.argmax()) + 1,
                       first_over=first_over(loss_rel, OFF_RTOL),
                       grad_norm_max_rel=float(norm_rel.max()),
                       grad_norm_first_over=first_over(norm_rel, GRAD_NORM_RTOL))
        result["arms"][arm] = row
    # both kernel arms together launch what kernels_temporal launches alone
    check_launches("kernels_temporal", forced_launches, device)
    return result


def off_section(res: dict, card: str, a) -> List[str]:
    n = res["steps"]
    lines = [
        f"Generated by `scripts/ab_kernels_cuda.py --dropout off --steps {n}` "
        f"({a.rows} rows, bs {a.bs}, float32, every dropout rate 0; card: {card}).",
        "",
        f"Decision rule (fixed before the first run on the card): at each of the first {n} "
        "steps of the plain arm's training, each kernel arm takes one step from the plain "
        "arm's weights and optimizer state at that step, on the same batch, through its "
        f"Trainer's step; its loss lies within {res['rtol']:g} and its gradient norm within "
        f"{res['grad_norm_rtol']:g} of the plain arm's, relative.  A failure is a fault of "
        "the port, not a reason to widen the bound.  The free-running trajectories "
        "(each arm's Trainer from the same init) bind nothing: the plain arm against "
        "itself from its init moved by one float32 ulp (the control row) shows how fast "
        "rounding grows along this training.",
        "",
        "| arm | held loss: largest gap (step) | first over | held grad norm: largest "
        "gap | first over | free-running: largest gap | first over "
        f"{res['rtol']:g} | launches #1 / #2 / #3 fwd / #3 bwd / #5 fwd / #5 bwd "
        "| free-running s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arm in (*KERNEL_ARMS, "control"):
        r, c = res["arms"][arm], res["launches"][arm]
        held = (f"{r['max_rel']:.3e} ({r['step_of_max']}) | {r['first_over'] or 'none'} "
                f"| {r['grad_norm_max_rel']:.3e} | {r['grad_norm_first_over'] or 'none'}"
                if arm != "control" else "| | |")
        lines.append(
            f"| {arm} | {held} | {r['free_max_rel']:.3e} | {r['free_first_over'] or 'none'} "
            f"| {c['fused_encoder_layer']} / {c['fused_encoder_layer_bwd']} / "
            f"{c['xpool_sim_fwd']} / {c['xpool_sim_bwd']} / {c['fused_temporal_layer']} / "
            f"{c['fused_temporal_layer_bwd']} | {res['seconds'][arm]:.2f} |")
    plain = res["forced"]["plain"]["loss"]
    lines += ["", f"Plain arm: {res['seconds']['plain']:.2f} s free-running; its losses at "
              f"steps 1, {n // 2} and {n}: "
              + ", ".join(f"{plain[i]:.6f}" for i in (0, n // 2 - 1, n - 1)) + ".",
              f"Verdict: **{'held' if off_ok(res) else 'FAILED'}**.", ""]
    return lines


def off_ok(res: dict) -> bool:
    return all(res["arms"][arm]["first_over"] is None
               and res["arms"][arm]["grad_norm_first_over"] is None for arm in KERNEL_ARMS)


# -------------------------------------------------------------- dropout paper
def run_seed(a, seed: int, device: torch.device, data, workdir: str) -> dict:
    """One paired seed: every arm from the plain arm's init for `seed`,
    a.epochs epochs, the metrics averaged over the last a.eval_last_k."""
    over = {**base_overrides(a), "train.seed": seed}
    init = init_state(arm_config("plain", over))
    rec = {"seed": seed, "setup": {k: getattr(a, k) for k in SETUP_KEYS}, "launches": {},
           "seconds": {}, "per_epoch": {}}
    for arm in ARMS:
        trainer = start(arm_config(arm, over), data, device,
                        os.path.join(workdir, f"seed{seed}_{arm}"), init)
        reset_counts()
        t0 = time.perf_counter()
        evals = []
        for epoch in range(1, a.epochs + 1):
            trainer.train_epoch(epoch)
            if epoch > a.epochs - a.eval_last_k:
                evals.append(flat_metrics(trainer.eval_epoch(epoch)))
        rec["seconds"][arm] = time.perf_counter() - t0
        rec["launches"][arm] = read_counts()
        check_launches(arm, rec["launches"][arm], device, evaluated=True)
        for k in ab_stats.METRICS:
            rec[f"{arm}_{k}"] = float(np.mean([m[k] for m in evals]))
        rec["per_epoch"][arm] = {k: [m[k] for m in evals] for k in ab_stats.METRICS}
        del trainer
        free(device)
    return rec


def paper_section(records: List[dict], card: str, a) -> List[str]:
    n = len(records)
    lines = [
        f"Generated by `scripts/ab_kernels_cuda.py --dropout paper --ab-seeds {n} "
        f"--epochs {a.epochs} --rows {a.rows} --bs {a.bs} --eval-last-k {a.eval_last_k}` "
        f"over {n} paired seeds ({', '.join(str(r['seed']) for r in records)}; families of "
        f"{FAMILY_SIZE} tracks {FAMILY_DELTA} apart); "
        f"{arm_config('plain', base_overrides(a)).model.compute_dtype}, the paper's "
        f"rates (temporal 0.8, X-Pool 0.3, DETR 0.1); card: {card}.",
        "",
    ] + ab_stats.seed_rule(a.rows, a.eval_last_k) + [
        "",
        "The arms of a seed draw their masks from one generator a step: the plain",
        "arm draws masks from it, a kernel arm one Philox seed a kernel call, so",
        "their masks differ while the weights, batches and the other sites' draws",
        "are shared as far as the draw order allows.  kernels_temporal's towers",
        "also run in float32 (#5), the plain arm's under bf16 autocast.",
        "",
    ]
    for arm in KERNEL_ARMS:
        stats = ab_stats.compare_seeds(records, a.rows, a.eval_last_k, a="plain", b=arm)
        launches = records[0]["launches"][arm]
        lines += [f"**{arm} against plain** (launches in seed {records[0]['seed']}'s run: "
                  + ", ".join(f"{k} {v}" for k, v in launches.items()) + ")", ""]
        lines += ab_stats.seed_table(stats, "plain", arm, "plain", arm)
        flagged = [k for k, s in stats.items() if not s["compatible"]]
        lines += ["", f"Per metric compatible: **{not flagged}**"
                  + (f" (outside their MDE: {', '.join(flagged)})" if flagged else "")
                  + f"; family-wise (Holm, 6 metrics, FWER 5%): "
                  f"**{'clean' if ab_stats.family_clean(stats) else 'REJECTED'}**.", ""]
    secs = {arm: sum(r["seconds"][arm] for r in records) for arm in ARMS}
    lines += ["Training and evaluation seconds over the seeds: "
              + ", ".join(f"{arm} {s:.1f}" for arm, s in secs.items())
              + f"; in all {sum(secs.values()):.1f}.", ""]
    return lines


# ---------------------------------------------------------------- fingerprint
def run_fingerprint(a, device: torch.device, data_root: str) -> dict:
    """Per scenario and arm, the loss components over the mask draws."""
    over = base_overrides(a, FLOAT32_NO_DROPOUT)
    plain_cfg = arm_config("plain", over)
    data = synthetic.open_synthetic(data_root, plain_cfg.data)
    batch, _ = next(iter(data.epoch_batches(a.fp_rows, shuffle=False)))
    batch = to_tensors(batch, device)
    init = init_state(plain_cfg)
    draws = {}
    launches = {}
    for scen, subsystems in SCENARIOS.items():
        rates = {k: v for s in subsystems for k, v in RATES[s].items()}
        n = a.draws if subsystems else NONE_DRAWS
        for arm in ARMS:
            cfg = arm_config(arm, {**over, **rates})
            model = MaDe(cfg).to(device)
            model.load_state_dict(init, strict=True)
            model.train()
            reset_counts()
            out = {c: [] for c in COMPONENTS}
            with torch.no_grad():
                for i in range(n):
                    gen = step_generator(SEED, i, device)
                    o = model(batch["frame_feats"], batch["frame_mask"], batch["segment_feats"],
                              batch["segment_mask"], v_duration=batch.get("v_duration"),
                              generator=gen)
                    _, log = total_loss(o, batch["spans_target"], cfg,
                                        music_codes=batch.get("music_codes"))
                    for c in COMPONENTS:
                        out[c].append(log[c])
            draws[(scen, arm)] = {c: [float(x) for x in torch.stack(v).cpu()]
                                  for c, v in out.items()}
            launches[(scen, arm)] = read_counts()
            check_launches(arm, launches[(scen, arm)], device, backward=False)
            del model
    free(device)
    return {"draws": draws, "launches": launches}


def rel_gap(got: Sequence[float], want: Sequence[float]) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / np.abs(want)))


def fingerprint_verdict(res: dict) -> dict:
    """Per kernel arm: the 'none' control's largest relative gap; in each
    enabled scenario, a component that no mask reaches (no spread in either
    arm) held as the control is, and the others compared with Holm's
    verdicts."""
    out = {}
    draws = res["draws"]
    for arm in KERNEL_ARMS:
        none_gap = max(rel_gap(draws[("none", arm)][c], draws[("none", "plain")][c])
                       for c in COMPONENTS)
        rows, fixed = {}, {}
        for scen in SCENARIOS:
            if scen == "none":
                continue
            for c in COMPONENTS:
                want, got = draws[(scen, "plain")][c], draws[(scen, arm)][c]
                if np.ptp(want) == 0 and np.ptp(got) == 0:
                    fixed[(scen, c)] = rel_gap(got, want)
                else:
                    rows[(scen, c)] = ab_stats.compare_draws(want, got)
        pvals = {f"{s}/{c}/mean": r["p_mean"] for (s, c), r in rows.items()}
        pvals.update({f"{s}/{c}/spread": r["p_spread"] for (s, c), r in rows.items()})
        rejected = ab_stats.holm(pvals) if pvals else {}
        none_max = max([none_gap, *fixed.values()])
        out[arm] = {"none_max_rel": none_max, "none_ok": none_max <= NONE_RTOL,
                    "fixed": fixed, "rows": rows,
                    "rejected": sorted(k for k, v in rejected.items() if v),
                    "clean": not any(rejected.values())}
    return out


def fingerprint_ok(verdict: dict) -> bool:
    return all(v["none_ok"] and v["clean"] for v in verdict.values())


def fingerprint_section(res: dict, verdict: dict, card: str, a) -> List[str]:
    lines = [
        f"Generated by `scripts/ab_kernels_cuda.py --fingerprint --draws {a.draws}` "
        f"(one {a.fp_rows}-row batch of a family store, float32, seed {SEED}; "
        f"card: {card}).",
        "",
        "Decision rule (fixed before the run): one set of weights and one batch; dropout",
        "on in one subsystem at a time (temporal 0.8, X-Pool 0.3, DETR 0.1, all) and",
        f"{a.draws} mask draws of each arm.  Per scenario and loss component the kernel",
        "arm's draws are held against the plain arm's: the means by Welch's t, the",
        "spreads by the Brown-Forsythe test (the F-ratio of the variances beside",
        "it).  Holm's step-down at FWER 5% runs over all of one arm's p-values",
        "(4 scenarios x 2 components x mean and spread); the arm is clean when",
        f"none is rejected.  The 'none' control ({NONE_DRAWS} draws, every rate 0) must",
        f"agree within {NONE_RTOL:g} relative, and so must a component that no mask",
        "of a scenario reaches (no spread in either arm: the retrieval loss under",
        "DETR dropout, the localization loss under X-Pool dropout), which leaves the",
        "family.  The temporal scenario reaches #5 only in",
        "kernels_temporal; in kernels both arms run its plain dropout.",
        "",
    ]
    for arm in KERNEL_ARMS:
        v = verdict[arm]
        lines += [f"**{arm} against plain**: none control largest relative gap "
                  f"{v['none_max_rel']:.3e} ({'held' if v['none_ok'] else 'FAILED'}); "
                  f"Holm: **{'clean' if v['clean'] else 'REJECTED ' + ', '.join(v['rejected'])}**.",
                  "",
                  "| scenario | component | plain mean ± std | kernel mean ± std | z | p (mean) "
                  "| F-ratio | p (F) | p (Brown-Forsythe) |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for (scen, c), r in v["rows"].items():
            lines.append(
                f"| {scen} | {c.replace('_loss', '')} | {r['a_mean']:.5f} ± {r['a_std']:.5f} "
                f"| {r['b_mean']:.5f} ± {r['b_std']:.5f} | {r['z']:+.2f} | {r['p_mean']:.3f} "
                f"| {r['f_ratio']:.3f} | {r['p_f']:.3f} | {r['p_spread']:.3f} |")
        lines.append("")
        if v["fixed"]:
            lines += ["No mask reaches (no spread in either arm, held as the control): "
                      + "; ".join(f"{scen} {c.replace('_loss', '')} {gap:.3e}"
                                  for (scen, c), gap in v["fixed"].items()) + ".", ""]
    return lines


# ----------------------------------------------------------------------- main
def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dropout", choices=["off", "paper"], default=None)
    p.add_argument("--fingerprint", action="store_true")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--ab-seeds", type=int, default=24)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--rows", type=int, default=768)
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--eval-last-k", type=int, default=4)
    p.add_argument("--draws", type=int, default=300)
    p.add_argument("--fp-rows", type=int, default=64)
    p.add_argument("--report", default="AB_PORT_REPORT.md")
    p.add_argument("--out", default=os.path.join("build", "ab"))
    p.add_argument("--stats-from", default=None,
                   help="write --dropout paper's section from its records (a JSONL) alone")
    a, rest = p.parse_known_args(argv)
    a.overrides = parse_kv_overrides(rest)
    if a.dropout is None and not a.fingerprint and not a.stats_from:
        p.error("give --dropout off|paper, --fingerprint or --stats-from")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.stats_from:
        with open(a.stats_from) as f:
            records = [json.loads(line) for line in f if line.strip()]
        for key, value in records[0].get("setup", {}).items():
            setattr(a, key, value)
        ab_stats.write_section(a.report, PAPER_HEADING,
                               paper_section(records, records[0]["card"], a))
        return 0
    device = resolve_device(a.device)
    card = card_line(device)
    print(card, flush=True)
    os.makedirs(a.out, exist_ok=True)
    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        if a.fingerprint:
            cfg = arm_config("plain", base_overrides(a))
            root = make_store(os.path.join(workdir, "fp_data"), cfg, a.fp_rows, a)
            res = run_fingerprint(a, device, root)
            verdict = fingerprint_verdict(res)
            ok &= fingerprint_ok(verdict)
            ab_stats.write_section(a.report, "Kernel path against plain path: dropout "
                                   "fingerprint", fingerprint_section(res, verdict, card, a))
            with open(os.path.join(a.out, "ab_kernels_fingerprint.json"), "w") as f:
                json.dump({"card": card, "draws": {"/".join(k): v for k, v in
                                                   res["draws"].items()},
                           "verdict": {arm: {**v, **{key: {"/".join(k): r for k, r in
                                                            v[key].items()}
                                                     for key in ("rows", "fixed")}}
                                       for arm, v in verdict.items()}}, f, indent=1)
            for arm, v in verdict.items():
                print(json.dumps({"fingerprint": arm, "none_max_rel": v["none_max_rel"],
                                  "clean": v["clean"], "rejected": v["rejected"]}), flush=True)
        if a.dropout:
            cfg = arm_config("plain", base_overrides(a))
            root = make_store(os.path.join(workdir, "data"), cfg, a.rows, a)
        if a.dropout == "off":
            res = run_off(a, device, root, workdir)
            ok &= off_ok(res)
            ab_stats.write_section(a.report, "Kernel path against plain path: dropout off",
                                   off_section(res, card, a))
            with open(os.path.join(a.out, "ab_kernels_off.json"), "w") as f:
                json.dump({"card": card, **res}, f, indent=1)
            print(json.dumps({"dropout_off": res["arms"], "rtol": OFF_RTOL,
                              "grad_norm_rtol": GRAD_NORM_RTOL}), flush=True)
        elif a.dropout == "paper":
            data = synthetic.open_synthetic(root, cfg.data)
            records = []
            path = os.path.join(a.out, "ab_kernels_paper.jsonl")
            for i in range(a.ab_seeds):
                rec = run_seed(a, FIRST_SEED + 13 * i, device, data, workdir)
                records.append(rec)
                with open(path, "a") as f:
                    f.write(json.dumps({"card": card, **rec}) + "\n")
                print(json.dumps({k: v for k, v in rec.items() if k != "per_epoch"}),
                      flush=True)
            ab_stats.write_section(a.report, PAPER_HEADING,
                                   paper_section(records, card, a))
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
