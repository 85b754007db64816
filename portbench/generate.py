"""The benchmark's one traffic generator: inputs and arrivals from a traffic
mix's parameters (`traffic/<name>.json`) and the run's seed.

Every seed gets the same multiset of sizes (video and track durations, and
for serving the same gaps between arrivals), in its own order, and its own
feature values; so seeds change which rows meet which, not how much work a
run does.  Features are drawn on the device, in one call a table.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, *stream])


def spread(n: int, lo: int, hi: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi] (each value as often as
    the others, give or take one), in ascending order."""
    return lo + (np.arange(n) * (hi - lo + 1)) // n


def snippets(track_s: np.ndarray, cfg: dict) -> np.ndarray:
    """Valid snippets of tracks this long: windows of filter_sec every
    stride, capped at max_snippet_num."""
    s_max = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    n = np.floor((track_s - cfg["data.filter_sec"]) / cfg["data.stride"]).astype(np.int64) + 1
    return np.clip(n, 1, s_max)


def masks(lengths: np.ndarray, width: int, device) -> torch.Tensor:
    """[N, width] uint8 with the first lengths[i] entries 1."""
    n = torch.as_tensor(lengths, device=device)
    return (torch.arange(width, device=device)[None, :] < n[:, None]).to(torch.uint8)


def features(shape: Tuple[int, ...], seed: int, stream: int, device) -> torch.Tensor:
    """Normal float16 features of the stream `stream` of the seed."""
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0]))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float16)


def train_tables(p: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The resident dataset in data/device_data.py::gather_batch's layout:
    p["video_rows"] videos (one training row each, durations spread over
    p["video_seconds"] at 1 frame a second), p["tracks"] tracks (durations
    spread over p["track_seconds"]), each row's track spread evenly over
    the catalog, its ground-truth moment a window of the video's length at
    a seeded start inside the track."""
    n, m = p["video_rows"], p["tracks"]
    f, s = cfg["data.max_v_frames"], int(cfg["data.max_m_duration"] / cfg["data.stride"])
    g = rng(seed, 1)
    v_s = g.permutation(spread(n, *p["video_seconds"]))
    t_s = g.permutation(spread(m, *p["track_seconds"]))
    track_of = g.permutation(np.arange(n) % m)
    dur = t_s[track_of]
    width = np.minimum(v_s, dur)
    start = g.random(n) * (dur - width)
    gt = np.stack([start, start + width], -1).astype(np.float32)[:, None, :]
    spans = np.stack([(start + width / 2) / cfg["data.max_m_duration"],
                      width / cfg["data.max_m_duration"]], -1).astype(np.float32)[:, None, :]
    to = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return {
        "vf": features((n, f, cfg["data.vit_dim"]), seed, 2, device),
        "vm": masks(np.minimum(v_s, f), f, device),
        "mf": features((m, s, cfg["data.ast_dim"]), seed, 3, device),
        "mm": masks(snippets(t_s, cfg), s, device),
        "video_rows": to(np.arange(n), torch.int64),
        "music_rows": to(track_of, torch.int64),
        "spans": to(spans), "gt": to(gt),
        "mdur": to(dur.astype(np.float32)), "vdur": to(v_s.astype(np.float32)),
    }


def eval_tables(p: dict, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """An evaluation split in the resident layout of `train_tables`:
    p["rows"] rows, each with a video of its own and, with p["tracks"]
    equal to p["rows"], a track of its own (as MGSV-EC's val and test
    splits), durations spread over p["video_seconds"] and
    p["track_seconds"]."""
    return train_tables(dict(p, video_rows=p["rows"]), cfg, seed, device)


def epoch_order(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """[n // batch, batch] row indices of one epoch: a seeded permutation,
    the last partial batch dropped, as the Trainer's stream."""
    order = rng(seed, 4, epoch).permutation(n)
    return order[: (n // batch) * batch].reshape(-1, batch)


def music_codes(track_of: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Each batch's rows' track as an integer code within the batch, as
    data/device_data.py::DeviceResidentData.epoch_batches computes it."""
    return np.stack([np.unique(track_of[i], return_inverse=True)[1] for i in idx]).astype(
        np.int32)


def arrivals(p: dict, seconds: float, seed: int) -> np.ndarray:
    """Arrival times (s from the window's start) of an open loop at
    p["rate_per_s"]: Poisson gaps taken at evenly spaced quantiles of the
    exponential (the same gaps for every seed) in a seeded order."""
    n = int(math.ceil(p["rate_per_s"] * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / p["rate_per_s"]
    return np.cumsum(rng(seed, 5).permutation(gaps))


def video_pool(p: dict, cfg: dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """p["pool"] request videos on the host: frame features [P, F, vit]
    (float16) and frame masks [P, F] of durations spread over
    p["video_seconds"], in a seeded order."""
    f = cfg["data.max_v_frames"]
    v_s = rng(seed, 6).permutation(spread(p["pool"], *p["video_seconds"]))
    feats = features((p["pool"], f, cfg["data.vit_dim"]), seed, 7, device)
    mask = masks(np.minimum(v_s, f), f, device)
    return (feats * mask[..., None]).cpu().numpy(), mask.cpu().numpy().astype(np.float32)


def catalog(p: dict, cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The served catalog's snippet features [M, S, ast] (float16, on the
    device) and masks [M, S], durations spread over p["track_seconds"]."""
    s = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    t_s = rng(seed, 8).permutation(spread(p["tracks"], *p["track_seconds"]))
    mask = masks(snippets(t_s, cfg), s, device)
    return features((p["tracks"], s, cfg["data.ast_dim"]), seed, 9, device) * mask[..., None], mask
