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
--cpu-devices / --coordinator: the port trains in one process on one
device.  The run writes history.json and the
checkpoints under train.output_dir/train.name and prints the best metrics
as JSON.
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
    known, rest = parser.parse_known_args(argv if argv is not None else sys.argv[1:])
    cfg = Config.from_overrides(parse_kv_overrides(rest))

    from mgsv_tpu_torch.data.dataset import MgsvDataset
    from mgsv_tpu_torch.train.loop import Trainer

    if known.synthetic:
        from mgsv_tpu_torch.data import synthetic
        root = os.path.join(cfg.train.output_dir, "synthetic_data")
        synthetic.generate(root, n_rows=known.synthetic, data_cfg=cfg.data,
                           family_size=known.synthetic_family_size)
        train_data = val_data = synthetic.open_synthetic(root, cfg.data)
    else:
        stores = [os.path.join(cfg.data.feature_root, s) for s in ("video_store", "music_store")]
        train_data = MgsvDataset.open(cfg.data.train_csv, *stores, cfg.data.max_m_duration)
        val_data = MgsvDataset.open(cfg.data.val_csv, *stores, cfg.data.max_m_duration)

    result = Trainer(cfg, train_data=train_data, val_data=val_data, device=known.device).fit()
    print(json.dumps({"best": result["best"]}, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
