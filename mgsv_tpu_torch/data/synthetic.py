"""Synthetic MGSV-EC-style dataset for tests and smoke runs, ported from
mgsv_tpu/data/synthetic.py.

Writes a CSV and packed feature stores with the shapes of the real dataset
(frames [50, 512], snippets [96, 768] by default).  Video and music features
of a matched pair share a low-rank latent, and the ground-truth moment is an
additive pattern on the in-span snippets, so both losses are learnable.  The
draws and their order are the JAX package's, and the CSV is written as
pandas writes it there, so one seed gives the same files in both packages.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from mgsv_tpu_torch.config import DataConfig
from mgsv_tpu_torch.data.dataset import MgsvDataset
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore


def generate(
    root: str,
    n_rows: int = 64,
    n_unique_music: Optional[int] = None,
    data_cfg: DataConfig = DataConfig(),
    seed: int = 0,
    latent_dim: int = 16,
    family_size: int = 1,
    family_delta: float = 0.35,
) -> str:
    """Writes the CSV and the stores under `root`; returns the CSV's path.

    family_size > 1 groups tracks into families that share a latent motif
    and differ by a `family_delta`-scaled offset, so retrieval starts near
    R@1 = 100 / family_size and has to be learned; 1 keeps every track
    separable."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    n_music = n_unique_music or max(2, n_rows // 2)

    f, s = data_cfg.max_v_frames, data_cfg.max_snippet_num
    vd, ad = data_cfg.vit_dim, data_cfg.ast_dim
    max_dur = data_cfg.max_m_duration

    video_ids = [f"v{i:06d}" for i in range(n_rows)]
    music_ids_pool = [f"m{i:06d}" for i in range(n_music)]
    music_of_row = [music_ids_pool[rng.randint(n_music)] for _ in range(n_rows)]

    if family_size > 1:
        n_fam = -(-n_music // family_size)
        fam_lat = rng.randn(n_fam, latent_dim).astype(np.float32)
        latent_of_music = {
            m: (fam_lat[j // family_size]
                + family_delta * rng.randn(latent_dim).astype(np.float32))
            for j, m in enumerate(music_ids_pool)
        }
    else:
        latent_of_music = {m: rng.randn(latent_dim).astype(np.float32)
                           for m in music_ids_pool}
    proj_v = rng.randn(latent_dim, vd).astype(np.float32)
    proj_a = rng.randn(latent_dim, ad).astype(np.float32)
    span_pattern = rng.randn(ad).astype(np.float32)

    m_total = rng.uniform(60, max_dur, n_music).astype(np.float32)
    m_total_of = dict(zip(music_ids_pool, m_total))

    # music store (unique tracks)
    seg_feats = np.zeros((n_music, s, ad), np.float16)
    seg_mask = np.zeros((n_music, s), np.uint8)
    starts, ends = {}, {}
    for j, m in enumerate(music_ids_pool):
        dur = m_total_of[m]
        n_valid = min(s, int(dur / data_cfg.stride) + 1)
        seg_mask[j, :n_valid] = 1
        lat = latent_of_music[m]
        base = (lat @ proj_a)[None, :] + 0.5 * rng.randn(s, ad)
        st = rng.uniform(0, max(1.0, dur - 15))
        ed = min(dur, st + rng.uniform(5, 40))
        starts[m], ends[m] = st, ed
        snip_t = np.arange(s) * data_cfg.stride
        in_span = (snip_t >= st) & (snip_t <= ed)
        base[in_span] += 2.0 * span_pattern
        seg_feats[j] = (base * seg_mask[j][:, None]).astype(np.float16)
    PackedFeatureStore.build(os.path.join(root, "music_store"), music_ids_pool,
                             {"feats": seg_feats, "mask": seg_mask})

    # video store (one per row)
    v_dur = rng.uniform(5, min(50, data_cfg.max_v_frames), n_rows).astype(np.float32)
    frame_feats = np.zeros((n_rows, f, vd), np.float16)
    frame_mask = np.zeros((n_rows, f), np.uint8)
    for i in range(n_rows):
        n_valid = max(1, int(v_dur[i]))
        frame_mask[i, :n_valid] = 1
        lat = latent_of_music[music_of_row[i]]
        base = (lat @ proj_v)[None, :] + 0.5 * rng.randn(f, vd)
        frame_feats[i] = (base * frame_mask[i][:, None]).astype(np.float16)
    PackedFeatureStore.build(os.path.join(root, "video_store"), video_ids,
                             {"feats": frame_feats, "mask": frame_mask})

    columns = {
        "video_id": video_ids,
        "music_id": music_of_row,
        "video_start": np.zeros(n_rows),
        "video_end": v_dur,
        "music_start": [starts[m] for m in music_of_row],
        "music_end": [ends[m] for m in music_of_row],
        "music_total_duration": [m_total_of[m] for m in music_of_row],
        "video_segment_duration": v_dur,
        "music_segment_duration": [ends[m] - starts[m] for m in music_of_row],
        "music_path": ["/synthetic"] * n_rows,
        "video_total_duration": v_dur,
        "video_width": [720] * n_rows,
        "video_height": [1280] * n_rows,
        "video_total_frames": (v_dur * 30).astype(int),
        "video_frame_rate": [30] * n_rows,
        "video_category": ["Synthetic"] * n_rows,
    }
    csv_path = os.path.join(root, "data.csv")
    with open(csv_path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*(_as_text(v) for v in columns.values())))
    return csv_path


def _as_text(values) -> list:
    """One column as pandas' `to_csv` writes it: a float32 column (an array
    of that dtype, or a list of only np.float32 scalars) in float32's
    shortest repr, any other float column as float64's, the rest by str."""
    if isinstance(values, np.ndarray):
        kind = values.dtype
    elif all(isinstance(x, np.float32) for x in values):
        kind = np.dtype(np.float32)
    elif all(isinstance(x, (float, np.floating)) for x in values):
        kind = np.dtype(np.float64)
    else:
        kind = None
    if kind == np.float32:
        return [str(np.float32(x)) for x in values]
    if kind == np.float64:
        return [repr(float(x)) for x in values]
    return [str(x) for x in values]


def open_synthetic(root: str, data_cfg: DataConfig = DataConfig()) -> MgsvDataset:
    return MgsvDataset.open(os.path.join(root, "data.csv"),
                            os.path.join(root, "video_store"),
                            os.path.join(root, "music_store"),
                            data_cfg.max_m_duration)
