"""Evaluation CLI of the PyTorch port: `python -m mgsv_tpu_torch.cli.evaluate`.

    # a checkpoint the port's trainer wrote, on the validation split
    python -m mgsv_tpu_torch.cli.evaluate --ckpt best_r1 --run-dir runs/made \
        --split val --save-json results.json
    # the four best-metric checkpoints, or every per-epoch one
    python -m mgsv_tpu_torch.cli.evaluate --test-best --run-dir runs/made
    python -m mgsv_tpu_torch.cli.evaluate --sweep-epochs --run-dir runs/made
    # a reference-format .bin, or the random init without --ckpt
    python -m mgsv_tpu_torch.cli.evaluate --ckpt made.bin
    # write a checkpoint as a reference-format .bin and stop
    python -m mgsv_tpu_torch.cli.evaluate --ckpt last --run-dir runs/made --export-torch made.bin

`--ckpt` is a tag under `--run-dir` (best_r1, last, epoch_3, ...), a
reference `.bin` (`pytorch_model.bin.N` included), or absent for the random
init of train.seed.  A `.bin`, read or written, holds neither the
EmbeddingNet aggregator nor the cls token: both refuse it, as the JAX CLI's
export and import do.  Config overrides and their defaults are the JAX CLI's;
`--device` (default cuda) replaces its platform flags.  The corpus X-Pool
similarity runs on the evaluation kernel on a CUDA device (the plain
blocked path on the CPU), so `--fused-sim`, the JAX CLI's switch to its
kernel, is accepted and changes nothing.  `--train.device_data` takes the
Trainer's policy (data/device_data.py::use_device_data): "on" makes the
split resident on the device, "auto" (the default) does so on a CUDA device
when its stores take under 6 GiB, "off" feeds it from the host.  Prints
each tag's metrics and, last, one `EVAL_RESULT` line.

`--coordinator host:port --num-processes N --process-id i` (or torchrun's
environment) evaluates over N ranks, one process each, as the train CLI
trains: each rank runs the eval step on its rows of every batch, the
evaluation kernel's tracks are split over the ranks, every rank prints
the same metrics and an `EVAL_RESULT` line with its process index, and
rank 0 alone writes `--save-json` and `--export-torch`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys

from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config


def _epoch_sweep_tags(ckpt, run_dir):
    """Every per-epoch checkpoint, sorted by epoch (test-MaDe.py:502-528):
    `ckpt_epoch_N` tags under --run-dir, or `pytorch_model.bin.N` files when
    --ckpt is a directory of reference checkpoints."""
    tags = []
    if ckpt and os.path.isdir(ckpt):
        for name in os.listdir(ckpt):
            m = re.fullmatch(r"pytorch_model\.bin\.(\d+)", name)
            if m:
                tags.append((int(m.group(1)), os.path.join(ckpt, name)))
    elif run_dir and os.path.isdir(run_dir):
        for name in os.listdir(run_dir):
            m = re.fullmatch(r"ckpt_epoch_(\d+)", name)
            if m:
                tags.append((int(m.group(1)), f"epoch_{m.group(1)}"))
    return [tag for _, tag in sorted(tags)]


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser("mgsv-torch-eval")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint tag (with --run-dir) or reference .bin path")
    parser.add_argument("--run-dir", type=str, default=None)
    parser.add_argument("--test-best", action="store_true",
                        help="sweep the best_{r1,iou,r1iou05,r1iou07} checkpoints")
    parser.add_argument("--sweep-epochs", action="store_true",
                        help="evaluate every per-epoch checkpoint: ckpt_epoch_* under "
                             "--run-dir, or pytorch_model.bin.* when --ckpt is a directory")
    parser.add_argument("--split", choices=["val", "test"], default="test")
    parser.add_argument("--save-json", type=str, default=None)
    parser.add_argument("--fused-sim", action="store_true",
                        help="accepted for the JAX CLI's sake; a CUDA device always "
                             "takes the evaluation kernel")
    parser.add_argument("--export-torch", type=str, default=None,
                        help="write the loaded checkpoint as a reference-format .bin "
                             "at PATH and stop")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="data parallelism: rank 0's host:port")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    known, rest = parser.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config.from_overrides(parse_kv_overrides(rest))

    from mgsv_tpu_torch.core import dist
    from mgsv_tpu_torch.core.checkpoint import load_weights
    from mgsv_tpu_torch.core.device import check_mesh_shape, resolve_device
    from mgsv_tpu_torch.core.mesh import make_mesh
    from mgsv_tpu_torch.data.dataset import MgsvDataset
    from mgsv_tpu_torch.data.device_data import DeviceResidentData, use_device_data
    from mgsv_tpu_torch.eval.evaluator import evaluate
    from mgsv_tpu_torch.eval.metrics import save_results_json
    from mgsv_tpu_torch.interop.from_jax import save_reference_bin
    from mgsv_tpu_torch.models.made import MaDe
    from mgsv_tpu_torch.train.step import make_eval_step

    joined = dist.initialize(known.coordinator, known.num_processes, known.process_id,
                             known.device)
    mesh = None
    if dist.process_count() > 1:
        mesh = make_mesh(cfg.train.mesh_shape)
        if not dist.is_primary():
            logging.getLogger().setLevel(logging.WARNING)
    else:
        check_mesh_shape(cfg.train.mesh_shape)
    device = resolve_device(dist.rank_device(known.device))
    model = MaDe(cfg).to(device).eval()
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    eval_step = make_eval_step(model, cfg, mesh=mesh)

    if known.test_best:
        tags = ["best_r1", "best_iou", "best_r1iou05", "best_r1iou07"]
    elif known.sweep_epochs:
        tags = _epoch_sweep_tags(known.ckpt, known.run_dir)
        if not tags:
            raise SystemExit("--sweep-epochs found no per-epoch checkpoints "
                             f"(ckpt={known.ckpt!r} run_dir={known.run_dir!r})")
        logging.info("sweeping %d epoch checkpoints: %s ... %s", len(tags), tags[0], tags[-1])
    else:
        tags = [known.ckpt]

    data = None
    all_results = {}
    for tag in tags:
        if tag is None:
            model.load_state_dict(init_state)
            tag = "random_init"
        else:
            try:
                load_weights(model, tag, known.run_dir or ".", cfg)
            except FileNotFoundError:
                logging.warning("checkpoint %s missing, skipped", tag)
                continue
        if known.export_torch:
            out = known.export_torch
            if len(tags) > 1:
                out = f"{out}.{os.path.basename(str(tag))}"   # one file per tag
            if dist.is_primary():
                save_reference_bin(model, cfg, out)
            logging.info("exported %s -> %s (reference torch format)", tag, out)
            all_results[tag] = {"exported": out}
            continue
        if data is None:
            csv = cfg.data.test_csv if known.split == "test" else cfg.data.val_csv
            data = MgsvDataset.open(csv, os.path.join(cfg.data.feature_root, "video_store"),
                                    os.path.join(cfg.data.feature_root, "music_store"),
                                    cfg.data.max_m_duration)
            if use_device_data(cfg.train.device_data, device, data,
                               1 if mesh is None else mesh.dp):
                data = DeviceResidentData(data, device, mesh)
                logging.info("device-resident dataset enabled on %s", data.device)
        res = evaluate(model, data, cfg, eval_step=eval_step, mesh=mesh)
        summary = {**res["retrieval"], **res["localization"], **res["composite"]}
        summary.pop("cols", None)
        all_results[tag] = summary
        print(tag, json.dumps(summary, indent=2, default=float))
        if known.save_json and dist.is_primary():
            loc_results = [
                dict(video_id=v, music_id=m, m_duration=float(d), gt_moment=g.tolist(),
                     pred_st=float(p[0]), pred_ed=float(p[1]))
                for v, m, d, g, p in zip(res["video_ids"], res["music_ids"],
                                         data.index.m_duration, data.index.gt_moment,
                                         res["pred_spans"])]
            save_results_json(res["ret_results"], loc_results, res["ious"], known.save_json,
                              cfg.data.max_m_duration)
    digest = {"process": dist.process_index(),
              "results": {str(t): ({k: float(v) for k, v in r.items()}
                                   if "exported" not in r else r)
                          for t, r in all_results.items()}}
    print("EVAL_RESULT " + json.dumps(digest, default=float), flush=True)
    if joined:
        dist.shutdown()
    return all_results


if __name__ == "__main__":
    main()
