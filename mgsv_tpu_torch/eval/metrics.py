"""Corpus-level retrieval, localization and composite metrics, ported from
mgsv_tpu/eval/metrics.py.

The host rankings (`dedup_rank`, `rect_rank`) are numpy copies of the JAX
package's; `dedup_rank_device` and `rect_rank_device` compute the same ranks
from a similarity matrix that stays on its device, so only the [N] rank
vector crosses to the host.  Semantics as the reference's
(utils/util_test.py): music-id deduplicated ranking, strict '>' IoU
thresholds, composite R@k ^ IoU>t over val_len, and R@k_miou divided by
val_len and by the hit count.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def dedup_rank(sim_matrix: np.ndarray, music_ids: Sequence[str]) -> np.ndarray:
    """Rank (0-based) of each row's GT music id among deduplicated ids.

    sim_matrix: [N, N] similarity, row i's GT is music_ids[i]."""
    n = sim_matrix.shape[0]
    codes = np.unique(np.asarray(music_ids), return_inverse=True)[1]  # [N] int
    order = np.argsort(-sim_matrix, axis=1, kind="stable")            # [N, N]
    sorted_codes = codes[order]                                       # [N, N]
    ranks = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = sorted_codes[i]
        _, first_idx = np.unique(row, return_index=True)
        # dedup position of element j = #distinct codes seen in row[:j+1] - 1
        is_first = np.zeros(n, dtype=bool)
        is_first[first_idx] = True
        dedup_pos = np.cumsum(is_first) - 1
        gt_first = np.flatnonzero(row == codes[i])[0]
        ranks[i] = dedup_pos[gt_first]
    return ranks


def rect_rank(sim_matrix: np.ndarray, col_music_ids: Sequence[str],
              gt_music_ids: Sequence[str]) -> np.ndarray:
    """Rank (0-based) of each row's GT track in a [N_videos, N_tracks]
    similarity over unique tracks: the deduplicated ranking without the
    duplicated columns.  A tied track counts before the GT iff its first
    occurrence in gt_music_ids is earlier (`_first_occurrence_keys`)."""
    sim_matrix = np.asarray(sim_matrix, dtype=np.float64)
    cols = np.asarray(col_music_ids)
    if len(np.unique(cols)) != len(cols):
        raise ValueError("columns must be unique tracks")
    col_of = {m: j for j, m in enumerate(cols)}
    gt_col = np.asarray([col_of[m] for m in gt_music_ids])
    gt_sim = sim_matrix[np.arange(len(gt_col)), gt_col]
    better = (sim_matrix > gt_sim[:, None]).sum(axis=1)
    ties = (sim_matrix == gt_sim[:, None])
    tie_key = _first_occurrence_keys(cols, col_of, gt_music_ids)
    tie_before = (ties & (tie_key[None, :] < tie_key[gt_col][:, None])).sum(axis=1)
    return better + tie_before


def _first_occurrence_keys(cols: np.ndarray, col_of: Dict,
                           gt_music_ids: Sequence[str]) -> np.ndarray:
    """Per unique-track column: first row index in gt_music_ids whose GT is
    that track, or N for tracks no video uses."""
    n = len(gt_music_ids)
    keys = np.full(len(cols), n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        keys[col_of[gt_music_ids[i]]] = i
    return keys


def dedup_rank_device(sim: torch.Tensor, music_ids: Sequence[str]) -> Tuple[np.ndarray,
                                                                             np.ndarray]:
    """`dedup_rank` computed where `sim` [N, N] lies; returns ([N] ranks,
    [N] top-1 column).  Id c counts before the GT iff (best_c, -earliest_c)
    beats (best_gt, -earliest_gt), best_c its best similarity in the row and
    earliest_c the first column reaching it: the order of the reference's
    stable argsort and first-occurrence scan."""
    n, m = sim.shape
    codes_np = np.unique(np.asarray(music_ids), return_inverse=True)[1]
    n_ids = int(codes_np.max()) + 1
    gt = torch.as_tensor(codes_np[:n], device=sim.device)[:, None]      # row i's GT id
    codes = torch.as_tensor(codes_np, device=sim.device).expand(n, m).contiguous()
    best = sim.new_full((n, n_ids), float("-inf")).scatter_reduce(
        1, codes, sim, "amax", include_self=True)
    cols = torch.arange(m, device=sim.device).expand(n, m)
    hit = torch.where(sim == best.gather(1, codes), cols, torch.full_like(cols, m))
    earliest = torch.full((n, n_ids), m, dtype=cols.dtype, device=sim.device).scatter_reduce(
        1, codes, hit, "amin", include_self=True)
    gt_best, gt_earliest = best.gather(1, gt), earliest.gather(1, gt)
    before = (best > gt_best) | ((best == gt_best) & (earliest < gt_earliest))
    top1 = sim.argmax(dim=1)                               # first column on ties
    return before.sum(dim=1).cpu().numpy(), top1.cpu().numpy()


def rect_rank_device(sim: torch.Tensor, col_music_ids: Sequence[str],
                     gt_music_ids: Sequence[str]) -> np.ndarray:
    """`rect_rank` computed where `sim` [N_videos, N_tracks] lies."""
    cols = np.asarray(col_music_ids)
    if len(np.unique(cols)) != len(cols):
        raise ValueError("columns must be unique tracks")
    col_of = {m: j for j, m in enumerate(cols)}
    gt_col = torch.as_tensor([col_of[m] for m in gt_music_ids], device=sim.device)
    tie_key = torch.as_tensor(_first_occurrence_keys(cols, col_of, gt_music_ids),
                              device=sim.device)
    gt_sim = sim.gather(1, gt_col[:, None])
    better = (sim > gt_sim).sum(dim=1)
    tie_before = ((sim == gt_sim) & (tie_key[None, :] < tie_key[gt_col][:, None])).sum(dim=1)
    return (better + tie_before).cpu().numpy()


def _recall_from_ranks(ranks: np.ndarray) -> Dict[str, float]:
    n = len(ranks)
    metrics: Dict[str, float] = {}
    for k in (1, 3, 5, 10, 20, 25, 50, 100):
        metrics[f"R{k}"] = float(np.sum(ranks < k)) * 100.0 / n
    metrics["MedianR"] = float(np.median(ranks) + 1)
    metrics["MeanR"] = float(np.mean(ranks) + 1)
    metrics["MRR"] = float(np.mean(1.0 / (ranks + 1)))
    return metrics


def recall_metrics_rect(sim_matrix, col_music_ids: Sequence[str],
                        gt_music_ids: Sequence[str]) -> Tuple[Dict[str, float], np.ndarray]:
    """Recall metrics over a rectangular video x unique-track similarity; a
    tensor ranks where it lies (rect_rank_device)."""
    if isinstance(sim_matrix, torch.Tensor):
        ranks = rect_rank_device(sim_matrix, col_music_ids, gt_music_ids)
    else:
        ranks = rect_rank(sim_matrix, col_music_ids, gt_music_ids)
    return _recall_from_ranks(ranks), ranks


def recall_metrics(sim_matrix, music_ids: Sequence[str]
                   ) -> Tuple[Dict[str, float], np.ndarray, List[dict]]:
    """Dedup recall metrics (util_test.py:32-97): (metrics, ranks,
    per-sample results).  A tensor ranks where it lies (dedup_rank_device),
    so only [N] integers reach the host."""
    ids = list(music_ids)
    if isinstance(sim_matrix, torch.Tensor):
        ranks, top1 = dedup_rank_device(sim_matrix, music_ids)
    else:
        sim_matrix = np.asarray(sim_matrix, dtype=np.float64)
        ranks = dedup_rank(sim_matrix, music_ids)
        top1 = np.argmax(sim_matrix, axis=1)     # first index on ties, same
    results = [dict(music_id=ids[i], rank=int(ranks[i]) + 1,
                    topk_music_ids=[ids[int(top1[i])]]) for i in range(len(ids))]
    return _recall_from_ranks(ranks), ranks, results


def iou_metrics(iou_list: np.ndarray) -> Dict[str, float]:
    """util_test.py:101-111 (strict > thresholds)."""
    iou = np.asarray(iou_list, dtype=np.float64)
    return {
        "mIoU": float(iou.mean()),
        "IoU@0.3": float((iou > 0.3).sum()) * 100.0 / len(iou),
        "IoU@0.5": float((iou > 0.5).sum()) * 100.0 / len(iou),
        "IoU@0.7": float((iou > 0.7).sum()) * 100.0 / len(iou),
    }


def composite_metrics(ranks: np.ndarray, iou_list: np.ndarray) -> Dict[str, float]:
    """Joint retrieval ^ localization, util_test.py:140-199."""
    ranks = np.asarray(ranks)
    iou = np.asarray(iou_list, dtype=np.float64)
    n = len(ranks)
    out: Dict[str, float] = {}
    for k in (1, 10, 50, 100):
        hit = (ranks + 1) <= k
        n_hit = int(hit.sum())
        out[f"R{k}_iou0.5"] = float((hit & (iou > 0.5)).sum()) / n * 100.0
        out[f"R{k}_iou0.7"] = float((hit & (iou > 0.7)).sum()) / n * 100.0
        # the reference divides the miou sums by val_len AND by the hit
        # count (util_test.py:191-198); kept as it is
        out[f"R{k}_miou"] = float(iou[hit].sum() / n / n_hit) if n_hit > 0 else 0.0
    return out


def save_results_json(ret_results: List[dict], loc_results: List[dict], iou_list: np.ndarray,
                      save_path: str, max_m_duration: float = 240.0) -> None:
    """Per-sample eval dump, util_test.py:202-226."""
    rows = []
    for ret, loc, iou in zip(ret_results, loc_results, iou_list):
        if ret["music_id"] != loc["music_id"]:
            raise ValueError(f"result rows out of step: {ret['music_id']} vs {loc['music_id']}")
        rows.append(dict(
            video_id=loc["video_id"],
            music_id=ret["music_id"],
            topk_mids=ret["topk_music_ids"],
            gt_mid_rank=ret["rank"],
            iou=round(float(iou), 4),
            m_duration=loc["m_duration"],
            gt_st=round(float(loc["gt_moment"][0][0]), 3),
            gt_ed=round(float(loc["gt_moment"][0][1]), 3),
            pred_st=round(max(float(loc["pred_st"]), 0.0), 3),
            pred_ed=round(min(float(loc["pred_ed"]), max_m_duration), 3),
        ))
    with open(save_path, "w") as f:
        json.dump(rows, f, indent=4)
