"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to its limit in limits/<cell>.json.

Training (three steps from the same weights on the same rows):
  loss_gap    the largest |loss - reference loss| / |reference loss| of a step
  grad_gap    the first step's clipped gradient (as Adam's first moment
              holds it), worst leaf (`pieces`): |norm - reference norm| over the larger
              of the reference leaf's norm and the median leaf's
  change_gap  the same of the weights' change over the checked steps, over
              the leaves whose reference gradient is at least a thousandth
              of the median leaf's (the others move under Adam by round-off
              alone, as a key's bias under softmax)
Evaluation (the window's last pass over the whole split):
  sim_gap     the largest |similarity - reference similarity| over the
              [N, N] corpus, over the standard deviation of the reference's
              entries
  span_gap_s  the largest |top-1 span bound - reference bound|, seconds
  ret_loss_gap  the largest |retrieval loss - reference| / |reference| of a
              batch (the in-batch dual and X-Pool InfoNCE); the eval loss,
              a mean over the batches, does not separate the control
  Ranks and recalls are not compared: with random weights near-ties swap
  on rounding.
Serving (a seeded sample of the window's requests):
  index_gap        the index's embeddings and tokens against the reference's
                   music tower, largest absolute gap over the largest value
  rank_gap         largest amount by which a served track's reference score
                   lies below the reference's own track of that rank
  score_gap        largest |served retrieval score - reference score|
  moment_gap_s     largest |served moment bound - reference bound|, seconds
  moment_score_gap largest |served moment score - reference score|
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def pieces(name: str, t: torch.Tensor) -> Iterator[Tuple[str, torch.Tensor]]:
    """A parameter as the model's leaves: the packed q|k|v projections of an
    attention (in_proj_weight, in_proj_bias) are three leaves, as the
    published model and the JAX package hold them."""
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        yield from zip((f"{name}.q", f"{name}.k", f"{name}.v"), t.chunk(3, dim=0))
    else:
        yield name, t


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.norm()) for n, t in tensors.items() for k, v in pieces(n, t)}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def worst_leaves(got, ref, names, n: int = 3) -> str:
    """The n leaves of the largest gap, for a line of the run's log."""
    gaps = leaf_gaps(got, ref, names)
    top = sorted(gaps, key=gaps.get, reverse=True)[:n]
    return ", ".join(f"{k} {gaps[k]:.4g} ({got[k]:.6g} vs {ref[k]:.6g})" for k in top)


def train(losses, first_grad, change, ref, weights) -> Dict[str, float]:
    ref_grad = leaf_norms(ref["first_grad"])
    ref_change = leaf_norms({n: ref["params"][n] - weights[n] for n in ref["first_grad"]})
    med = float(np.median(list(ref_grad.values())))
    moving = [n for n in ref_grad if ref_grad[n] >= 1e-3 * med]
    print(f"portbench: losses {losses} reference {ref['losses']}", flush=True)
    print(f"portbench: worst gradient leaves: {worst_leaves(first_grad, ref_grad, ref_grad)}",
          flush=True)
    print(f"portbench: worst change leaves: {worst_leaves(change, ref_change, moving)}",
          flush=True)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": max(leaf_gaps(first_grad, ref_grad, list(ref_grad)).values()),
        "change_gap": max(leaf_gaps(change, ref_change, moving).values()),
    }


def evaluation(got: dict, ref: dict) -> Dict[str, float]:
    """got / ref: "sim" [N, N], "spans" [N, 2] and "retrieval_losses" [batches]
    (numpy)."""
    rl, ref_rl = got["retrieval_losses"], ref["retrieval_losses"]
    return {
        "sim_gap": float(np.abs(got["sim"] - ref["sim"]).max() / ref["sim"].std()),
        "span_gap_s": float(np.abs(got["spans"] - ref["spans"]).max()),
        "ret_loss_gap": float((np.abs(rl - ref_rl) / np.abs(ref_rl)).max()),
    }


def serve(served: dict, ref: dict) -> Dict[str, float]:
    """served / ref: numpy arrays.  served: ids [K, k] (index rows), scores
    [K, k], moments [K, k, 2], moment_scores [K, k], emb / tok (the
    program's index rows of `tracks`); ref: sims [K, M], moments,
    moment_scores, emb, tok of the same."""
    sims = ref["sims"]
    k = served["ids"].shape[1]
    best = -np.sort(-sims, axis=1)[:, :k]
    picked = np.take_along_axis(sims, served["ids"], 1)
    return {
        "index_gap": float(max(
            np.abs(served["emb"] - ref["emb"]).max() / np.abs(ref["emb"]).max(),
            np.abs(served["tok"] - ref["tok"]).max() / np.abs(ref["tok"]).max())),
        "rank_gap": float((best - picked).max()),
        "score_gap": float(np.abs(served["scores"] - picked).max()),
        "moment_gap_s": float(np.abs(served["moments"] - ref["moments"]).max()),
        "moment_score_gap": float(np.abs(served["moment_scores"] - ref["moment_scores"]).max()),
    }


def numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
