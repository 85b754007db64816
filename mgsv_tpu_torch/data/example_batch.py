"""A batch of precomputed features shaped like a training batch, from a seed.

The port's copy of the generator the JAX package's entry point uses
(`_example_batch` in `__graft_entry__.py`): the same keys, shapes, dtypes
and draws from a numpy RandomState, so the two packages see the same batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mgsv_tpu_torch.config import Config


def example_batch(rng: np.random.RandomState, cfg: Config, bs: int) -> Dict[str, np.ndarray]:
    """Random features with ~80% valid frames/snippets (the first always
    valid), one target moment at the middle of the track."""
    d = cfg.data
    f, s = d.max_v_frames, d.max_snippet_num
    batch = {
        "frame_feats": rng.randn(bs, f, d.vit_dim).astype(np.float32),
        "frame_mask": (rng.rand(bs, f) < 0.8).astype(np.float32),
        "segment_feats": rng.randn(bs, s, d.ast_dim).astype(np.float32),
        "segment_mask": (rng.rand(bs, s) < 0.8).astype(np.float32),
        "spans_target": np.stack(
            [np.full((bs, 1), 0.5, np.float32), np.full((bs, 1), 0.2, np.float32)],
            axis=-1),
        "gt_moment": np.tile(np.asarray([[96.0, 144.0]], np.float32), (bs, 1))[:, None, :],
        "m_duration": np.full((bs,), 200.0, np.float32),
        "v_duration": np.full((bs,), 30.0, np.float32),
    }
    batch["frame_mask"][:, 0] = 1
    batch["segment_mask"][:, 0] = 1
    return batch


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device` (float arrays as float32)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
