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
                    the report names the first step over it.
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
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.core.mesh import make_mesh as jax_make_mesh
from mgsv_tpu.data.synthetic import open_synthetic as jax_open_synthetic
from mgsv_tpu.train.loop import Trainer as JaxTrainer
from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.interop.from_jax import jax_variables_to_state_dict, load_jax_params
from mgsv_tpu_torch.train.loop import Trainer

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
    t0 = time.perf_counter()
    jax_fit = jt.fit()
    t1 = time.perf_counter()
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
            "history": history, "jax_seconds": t1 - t0, "port_seconds": t2 - t1}


def off_section(res: dict, a) -> List[str]:
    steps_per_epoch = a.rows // a.bs
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
            print(json.dumps({k: res[k] for k in ("steps", "first_over", "held")}))
            return 0 if res["held"] else 1
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
