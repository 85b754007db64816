"""Train CLI of the PyTorch port: `python -m mgsv_tpu_torch.cli.train`.

    # one epoch on 2,048 generated rows at the paper's widths, on the GPU
    python -m mgsv_tpu_torch.cli.train --synthetic 2048 --train.epochs 1
    # MGSV-EC features (--data.train_csv, --data.val_csv, --data.feature_root)
    python -m mgsv_tpu_torch.cli.train --data.feature_root features/Kuai_feature

Config overrides are the JAX CLI's `--section.key value` pairs; defaults
are the paper configuration.  `--train.gradient_accumulation_steps k`
updates once per k micro-batches (optax.MultiSteps' mean);
`--train.device_data on|off|auto` makes the data resident on the device
("auto", the default: on a CUDA device when the stores take under 6 GiB).
`--device` (default cuda) takes the place of the JAX CLI's --platform /
--cpu-devices.  The run writes history.json and the checkpoints under
train.output_dir/train.name and prints the best metrics as JSON.

Data parallelism, one process a rank, as the JAX CLI's multi-process
launch (mgsv_tpu/cli/train.py:38-43, :66-135):

    # two ranks on one host (each its own card, NCCL; gloo where they share
    # one card or run on the CPU)
    python -m mgsv_tpu_torch.cli.train --coordinator localhost:29500 \
        --num-processes 2 --process-id 0 --synthetic 2048 &
    python -m mgsv_tpu_torch.cli.train --coordinator localhost:29500 \
        --num-processes 2 --process-id 1 --synthetic 2048
    # or torchrun, whose environment stands in for the three flags
    torchrun --nproc-per-node 2 -m mgsv_tpu_torch.cli.train --synthetic 2048

`--train.mesh_shape '[dp,mp]'` lays dp x mp ranks out as JAX's (dp, mp)
mesh (core/mesh.py): the rows split over dp, the mp replicas of a dp index
repeat its training, and the evaluation's corpus similarity splits over
both axes.  Each rank trains on its dp index's rows of every global batch
of train.batch_size_train; rank 0 writes the synthetic data (the others wait
at a barrier), the checkpoints and history.json, the other ranks log at
WARNING, and every rank prints one `MP_RESULT` line with its per-epoch
losses, evaluation R1 and mIoU and the best metrics, which equal across
ranks.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser("mgsv-torch-train")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on a generated synthetic dataset of N rows")
    parser.add_argument("--synthetic-family-size", type=int, default=1,
                        help="confusable-track family size for --synthetic (>1 makes "
                             "retrieval non-saturating)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="data parallelism: rank 0's host:port (the reference's "
                             "init_process_group, train-MaDe.py:25)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    known, rest = parser.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config.from_overrides(parse_kv_overrides(rest))

    from mgsv_tpu_torch.core import dist
    from mgsv_tpu_torch.data.dataset import MgsvDataset
    from mgsv_tpu_torch.train.loop import Trainer

    joined = dist.initialize(known.coordinator, known.num_processes, known.process_id,
                             known.device)
    multiproc = dist.process_count() > 1
    if multiproc and not dist.is_primary():
        # one log stream per run; the other ranks speak when something is wrong
        logging.getLogger("mgsv_tpu_torch").setLevel(logging.WARNING)

    if known.synthetic:
        from mgsv_tpu_torch.data import synthetic
        root = os.path.join(cfg.train.output_dir, "synthetic_data")
        if dist.is_primary():
            synthetic.generate(root, n_rows=known.synthetic, data_cfg=cfg.data,
                               family_size=known.synthetic_family_size)
        dist.barrier("synthetic-data")       # one writer: the others open it after
        train_data = val_data = synthetic.open_synthetic(root, cfg.data)
    else:
        stores = [os.path.join(cfg.data.feature_root, s) for s in ("video_store", "music_store")]
        train_data = MgsvDataset.open(cfg.data.train_csv, *stores, cfg.data.max_m_duration)
        val_data = MgsvDataset.open(cfg.data.val_csv, *stores, cfg.data.max_m_duration)

    result = Trainer(cfg, train_data=train_data, val_data=val_data, device=known.device).fit()
    print(json.dumps({"best": result["best"]}, indent=2, default=float))
    if multiproc:
        # one machine-parsable line a rank: equal across ranks when the
        # gradients sync
        digest = {
            "process": dist.process_index(),
            "losses": [r["train"]["loss"] for r in result["history"]],
            "eval_R1": [r["eval"]["R1"] for r in result["history"] if "eval" in r],
            "eval_mIoU": [r["eval"]["mIoU"] for r in result["history"] if "eval" in r],
            "best": result["best"],
        }
        print("MP_RESULT " + json.dumps(digest, default=float), flush=True)
    if joined:
        dist.shutdown()
    return result


if __name__ == "__main__":
    main()
