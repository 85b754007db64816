"""Training steps back to back on a device-resident dataset.

Set-up makes the dataset's tables on the device in
data/device_data.py::gather_batch's layout and the weights from the seed,
builds the program's model, its three-group Adam and
train/step.py::make_train_step's step, and drives that one step through
its first `checked_steps` steps with the window's own feed (each batch
gathered by the port's gather_batch from a seeded permutation, so every
row differs); what those steps leave (each loss, the first clipped
gradient as Adam's first moment holds it, the weights before the next
step) is what the check compares.  Then `warm_steps` more, and the window:
steps until `--seconds` have passed on the host clock, with the Trainer's
one sampled loss read every 50 steps and no other wait for the device,
closed by a synchronize.  With `--trace 1`, `trace_steps` more steps run
under the profiler.  Once the window has closed and the memory peak is
read, the program is freed and the plain reference (reference/made.py)
runs the checked steps from the same weights on the same rows.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import check, flops, generate
from portbench.harness import (Cell, LayerContext, Outcome, counter_paths,
                               port_config, read_counter, settle)
from portbench.reference import made as R
from portbench.reference.precision import lowered
from portbench.trace import traced
from portbench.weights import make_weights

FAULTS = ("unchanged_state", "half_batch")


def run(cell: Cell, args, device: torch.device, t0: float, fault=None) -> Outcome:
    from mgsv_tpu_torch.data.device_data import gather_batch
    from mgsv_tpu_torch.models.made import MaDe
    from mgsv_tpu_torch.train.optimizer import make_optimizer
    from mgsv_tpu_torch.train.step import make_train_step

    p, flat, seed = cell.traffic, cell.config, args.seed
    cfg = port_config(flat, seed)
    batch_size = cfg.train.batch_size_train
    tree = generate.train_tables(p, flat, seed, device)
    track_of = tree["music_rows"].cpu().numpy()
    weights = make_weights(flat, seed, device)
    with torch.device(device):
        model = MaDe(cfg, torch.Generator(device).manual_seed(0))
    model.to(device).load_state_dict(weights, strict=True)
    total_steps = (p["video_rows"] // batch_size) * cfg.train.epochs
    opt = make_optimizer(model, cfg, total_steps)
    if fault == "unchanged_state":
        opt.step = lambda: None
    step = make_train_step(model, cfg, opt)

    state = {"epoch": -1, "i": 0, "idx": None, "codes": None, "rows": []}

    def next_batch(range_name=None):
        if state["idx"] is None or state["i"] == state["idx"].shape[0]:
            state["epoch"] += 1
            idx = generate.epoch_order(p["video_rows"], batch_size, seed, state["epoch"])
            state["rows"].append(idx)
            state["idx"] = torch.as_tensor(idx, device=device)
            state["codes"] = torch.as_tensor(generate.music_codes(track_of, idx), device=device)
            state["i"] = 0
        i = state["i"]
        state["i"] += 1
        if range_name:
            with torch.profiler.record_function(range_name):
                batch = gather_batch(tree, state["idx"][i])
        else:
            batch = gather_batch(tree, state["idx"][i])
        batch["music_codes"] = state["codes"][i]
        if fault == "half_batch":
            batch = {k: v[: batch_size // 2] for k, v in batch.items()}
        return batch

    # the checked steps, through the window's own call and feed
    params = dict(model.named_parameters())
    p0 = {n: t.detach().clone() for n, t in params.items()}
    b1 = cfg.train.adam_b1
    losses, first_grad = [], None
    for k in range(p["checked_steps"]):
        losses.append(step(next_batch())["loss"])
        if k == 0:
            first_grad = check.leaf_norms({n: mu / (1.0 - b1) for n, (mu, _) in opt.state.items()})
    change = check.leaf_norms({n: params[n].detach() - p0[n] for n in opt.state})
    losses = [float(x) for x in losses]
    del p0
    for _ in range(p["warm_steps"]):
        step(next_batch())
    settle()
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    setup_s = time.time() - t0

    # the window
    logs, host_s, steps = [], 0.0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < args.seconds:
        batch = next_batch()
        h = time.perf_counter()
        log = step(batch)
        host_s += time.perf_counter() - h
        steps += 1
        logs.append(log["loss"])
        if steps % p["loss_check_every"] == 1 and not math.isfinite(float(log["loss"])):
            break
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    window_s = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(logs))).sum())
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    layer = None
    if args.trace:
        paths = counter_paths()
        before = {c: read_counter(c) for c in paths}
        got = {}
        with traced(got):
            for _ in range(p["trace_steps"]):
                b = next_batch("portbench.gather_batch")
                with torch.profiler.record_function("portbench.train_step"):
                    step(b)
        counters = {c: read_counter(c) - before[c] for c in paths}
        prec = "bf16" if cfg.model.compute_dtype == "bfloat16" else "tf32"
        host = {"step_host_s": host_s / max(steps, 1), "window_s": window_s, "units": steps,
                "flops": flops.train_step_flops(flat, batch_size)["train_step"] * steps}
        layer = LayerContext(cell, host, got["summary"], counters, p["trace_steps"],
                             batch=batch_size, detr_rows=[batch_size] * p["trace_steps"],
                             detr_precision=prec, peak_flops=flops.PEAK_FLOPS[prec])

    # free the program, then the reference on the same rows
    checked_rows = [torch.as_tensor(state["rows"][0][k], device=device)
                    for k in range(p["checked_steps"])]
    ref_batches = [R.gather(tree, idx) for idx in checked_rows]
    del model, opt, step, tree, params, logs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with lowered("fp32"):
        ref = R.train_steps(weights, flat, ref_batches, seed, total_steps)
    checks = check.train(losses, first_grad, change, ref, weights)
    return Outcome(
        end_to_end={"train_clips_per_s": steps * batch_size / window_s, "setup_s": setup_s},
        checks=checks, attempted=steps, failed=failed, memory_peak_bytes=memory_peak,
        layer=layer)
