"""Statistics and report sections of the port's trained-behaviour A/B.

Shared by scripts/ab_port_vs_jax.py (the port against the JAX package, on
the CPU) and scripts/ab_kernels_cuda.py (the port's kernel path against its
plain path, on the card).  Imports neither JAX nor either package.

Seed comparison (`compare_seeds`), the twin of
scripts/ab_trained_behavior.py::welch_stats: both sides of a record start
from the same weights, so each seed is one matched pair.  The primary test
is a paired t on the per-seed differences; Welch's unpaired t is reported
beside it.  A metric is compatible when its gap is within its minimum
detectable effect, max(t95 x paired SE, the metric's resolution), where the
resolution is the change one sample can make (100 / rows points for R@k
and IoU@0.5, 1 / rows for MRR and mIoU, over the number of evaluations
averaged).  The binding verdict is family-wise: Holm's step-down over the
six metrics at a family-wise error of 5%, and a rejection needs a gap above
the resolution.  Fewer than two seeds raise: a paired variance needs two.

Dropout fingerprint (`compare_draws`): the loss components over N mask
draws of two implementations, same weights and batch.  The means by
Welch's t, the spreads by the Brown-Forsythe test (Levene's test about the
median, robust to skew) with the F-ratio of the variances reported beside
it; both families of p-values go through Holm at 5% over every
comparison of one arm (`holm`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence

import numpy as np

METRICS = ("R1", "R5", "R10", "MRR", "mIoU", "IoU@0.5")
FWER = 0.05
_UNIT_METRICS = ("MRR", "mIoU")     # means in [0, 1]; the rest are percentages


def resolution(key: str, rows: int, avg_k: int = 1) -> float:
    """The smallest change one sample can make to `key` over `rows` rows,
    in the average of `avg_k` evaluations."""
    quantum = 1.0 / rows if key in _UNIT_METRICS else 100.0 / rows
    return quantum / max(1, avg_k)


def holm(pvalues: Dict[str, float], alpha: float = FWER) -> Dict[str, bool]:
    """Holm's step-down: sort the p-values, reject while p_(i) <= alpha /
    (m - i), stop at the first that is not.  Returns key -> rejected."""
    items = sorted(pvalues.items(), key=lambda kv: kv[1])
    m = len(items)
    out = {}
    stopped = False
    for i, (key, p) in enumerate(items):
        stopped = stopped or p > alpha / (m - i)
        out[key] = not stopped
    return out


def compare_seeds(records: Sequence[dict], rows: int, avg_k: int = 1,
                  a: str = "ref", b: str = "our",
                  keys: Iterable[str] = METRICS) -> Dict[str, dict]:
    """Per metric, side `b` against side `a` over the seeds of `records`
    (each holds f"{a}_{key}" and f"{b}_{key}"): the paired and Welch
    comparisons and Holm's verdict (module docstring)."""
    from scipy import stats as sps

    keys = tuple(keys)
    n = len(records)
    if n < 2:
        raise ValueError(f"{n} seed(s): the paired comparison needs at least 2")
    out = {}
    for key in keys:
        av = np.asarray([r[f"{a}_{key}"] for r in records], np.float64)
        bv = np.asarray([r[f"{b}_{key}"] for r in records], np.float64)
        res = resolution(key, rows, avg_k)
        gap = float(abs(bv.mean() - av.mean()))
        va, vb = av.var(ddof=1) / n, bv.var(ddof=1) / n
        se_w = float(np.sqrt(va + vb))
        if va + vb > 0:
            df_w = (va + vb) ** 2 / (va ** 2 / (n - 1) + vb ** 2 / (n - 1))
            t95_w = float(sps.t.ppf(0.975, df_w))
            p_w = float(2.0 * sps.t.sf(gap / se_w, df_w))
        else:
            df_w, t95_w, p_w = float(2 * n - 2), 0.0, (1.0 if gap == 0.0 else 0.0)
        d = bv - av
        se_p = float(np.sqrt(d.var(ddof=1) / n))
        if se_p > 0:
            t95_p = float(sps.t.ppf(0.975, n - 1))
            p_p = float(2.0 * sps.t.sf(abs(d.mean()) / se_p, n - 1))
        else:
            t95_p, p_p = 0.0, (1.0 if gap == 0.0 else 0.0)
        mde = max(t95_p * se_p, res)
        out[key] = {
            f"{a}_mean": float(av.mean()), f"{a}_std": float(av.std(ddof=1)),
            f"{b}_mean": float(bv.mean()), f"{b}_std": float(bv.std(ddof=1)),
            "gap": gap, "diff_mean": float(d.mean()), "diff_std": float(d.std(ddof=1)),
            "paired_se": se_p, "paired_t95": t95_p,
            "paired_ci95_halfwidth": t95_p * se_p, "p_paired": p_p,
            "welch_se": se_w, "welch_df": float(df_w), "welch_t95": t95_w,
            "p_welch": p_w, "mde": float(mde), "mde_welch": float(max(t95_w * se_w, res)),
            "pair_corr": (float(np.corrcoef(av, bv)[0, 1])
                          if av.std() > 0 and bv.std() > 0 else 0.0),
            "resolution": res, "compatible": bool(gap <= mde),
        }
    rejected = holm({k: out[k]["p_paired"] for k in keys})
    for k in keys:
        out[k]["holm_reject"] = bool(rejected[k] and out[k]["gap"] > out[k]["resolution"])
    return out


def family_clean(stats: Dict[str, dict]) -> bool:
    return not any(s["holm_reject"] for s in stats.values())


def compare_draws(a: Sequence[float], b: Sequence[float]) -> dict:
    """Draws of one loss component under implementation `b` against `a`:
    means by Welch's t (z = mean gap / combined SE), spreads by the
    Brown-Forsythe test and the F-ratio var(b) / var(a) with its two-sided
    p-value."""
    from scipy import stats as sps

    av, bv = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na, nb = len(av), len(bv)
    if na < 2 or nb < 2:
        raise ValueError(f"{na} and {nb} draws: the spread needs at least 2 a side")
    va, vb = av.var(ddof=1), bv.var(ddof=1)
    se = float(np.sqrt(va / na + vb / nb))
    if se > 0:
        p_mean = float(sps.ttest_ind(bv, av, equal_var=False).pvalue)
        z = float((bv.mean() - av.mean()) / se)
    else:
        z, p_mean = 0.0, (1.0 if bv.mean() == av.mean() else 0.0)
    if va > 0 and vb > 0:
        f = float(vb / va)
        p_f = float(2.0 * min(sps.f.cdf(f, nb - 1, na - 1), sps.f.sf(f, nb - 1, na - 1)))
        p_bf = float(sps.levene(av, bv, center="median").pvalue)
    else:
        f = 1.0 if va == vb else float("inf")
        p_f = p_bf = 1.0 if va == vb else 0.0
    return {"a_mean": float(av.mean()), "a_std": float(np.sqrt(va)),
            "b_mean": float(bv.mean()), "b_std": float(np.sqrt(vb)),
            "diff": float(bv.mean() - av.mean()), "se": se, "z": z, "p_mean": p_mean,
            "f_ratio": f, "p_f": min(p_f, 1.0), "p_spread": p_bf}


def write_section(path: str, heading: str, lines: List[str]) -> None:
    """Put `lines` under the level-2 heading `heading` in the markdown file
    at `path`: the section of that heading is replaced up to the next
    level-2 heading, or appended; the file is made with a title if absent."""
    title = "# Trained-behaviour A/B of the PyTorch port"
    text = open(path).read() if os.path.exists(path) else title + "\n"
    head = f"## {heading}"
    body = [head, ""] + list(lines)
    old = text.split("\n")
    if head in old:
        start = old.index(head)
        end = next((i for i in range(start + 1, len(old)) if old[i].startswith("## ")),
                   len(old))
        new = old[:start] + body + [""] + old[end:]
    else:
        new = old + ([""] if old[-1] else []) + body + [""]
    with open(path + ".tmp", "w") as f:
        f.write("\n".join(new).rstrip("\n") + "\n")
    os.replace(path + ".tmp", path)


def seed_table(stats: Dict[str, dict], a: str, b: str, a_name: str, b_name: str) -> List[str]:
    """The per-metric table of `compare_seeds`' result."""
    lines = [f"| metric | {a_name} (mean ± std) | {b_name} (mean ± std) | gap "
             "| paired 95% CI ± | paired MDE | Welch MDE | pair corr | p (paired) "
             "| p (Welch) | compatible | Holm |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for k, s in stats.items():
        lines.append(
            f"| {k} | {s[f'{a}_mean']:.3f} ± {s[f'{a}_std']:.3f} "
            f"| {s[f'{b}_mean']:.3f} ± {s[f'{b}_std']:.3f} | {s['gap']:.3f} "
            f"| {s['paired_ci95_halfwidth']:.3f} | {s['mde']:.3f} | {s['mde_welch']:.3f} "
            f"| {s['pair_corr']:+.2f} | {s['p_paired']:.3f} | {s['p_welch']:.3f} "
            f"| {'yes' if s['compatible'] else 'NO'} "
            f"| {'REJECT' if s['holm_reject'] else 'clean'} |")
    return lines


def seed_rule(rows: int, avg_k: int) -> List[str]:
    """The decision rule of a seed comparison, stated before its numbers."""
    return [
        "Decision rule (fixed before the run): the seeds are matched pairs (both",
        "sides of a seed start from the same weights and see the same batches).",
        "Per metric the primary test is a paired t on the per-seed differences;",
        "Welch's unpaired t stands beside it.  A metric is compatible when its gap",
        "is at most max(t95 x paired SE, resolution); the resolution is one",
        f"sample's change at {rows} rows ({100.0 / rows:.4f} points for R@k and",
        f"IoU@0.5, {1.0 / rows:.5f} for MRR and mIoU), divided by the {avg_k}",
        "evaluations averaged.  The binding verdict is family-wise: Holm's",
        "step-down over the six metrics at FWER 5% on the paired p-values, where",
        "a rejection also needs a gap above the resolution.  The family is clean",
        "when no metric is rejected.",
    ]
