"""MGSV-EC CSV index, ported from mgsv_tpu/data/csv_index.py.

Parses a dataset CSV (the schema of dataset/MGSV-EC/test_data.csv) into
columnar numpy arrays once, with the `csv` module, and precomputes the
targets of the whole split: the same arrays and dtypes as the JAX package's
pandas reader.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class CsvIndex:
    video_ids: List[str]
    music_ids: List[str]
    v_duration: np.ndarray       # [N] video_end - video_start (seconds)
    m_duration: np.ndarray       # [N] music_total_duration (seconds)
    gt_moment: np.ndarray        # [N, 1, 2] (music_start, music_end) seconds
    spans_target: np.ndarray     # [N, 1, 2] normalized (center, width)
    video_start: np.ndarray = None   # [N] seconds
    video_end: np.ndarray = None     # [N] seconds

    def __len__(self) -> int:
        return len(self.video_ids)


def load_csv_index(csv_path: str, max_m_duration: float = 240.0) -> CsvIndex:
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))

    def col(name: str) -> np.ndarray:
        return np.asarray([float(r[name]) for r in rows], np.float64)

    video_ids = [r["video_id"] for r in rows]
    music_ids = [r["music_id"] for r in rows]
    v_start, v_end = col("video_start"), col("video_end")
    v_dur = (v_end - v_start).astype(np.float32)
    m_dur = col("music_total_duration").astype(np.float32)
    start = col("music_start").astype(np.float32)
    end = col("music_end").astype(np.float32)
    gt = np.stack([start, end], axis=-1)[:, None, :]          # [N, 1, 2]

    # get_cw_propotion (dataloader_MGSV_EC_feature.py:18-27): end clamped.
    end_c = np.minimum(end, max_m_duration)
    center = (start + end_c) / 2.0 / max_m_duration
    width = (end_c - start) / max_m_duration
    spans = np.stack([center, width], axis=-1)[:, None, :].astype(np.float32)

    return CsvIndex(video_ids, music_ids, v_dur, m_dur, gt.astype(np.float32), spans,
                    video_start=v_start.astype(np.float32), video_end=v_end.astype(np.float32))
