"""The control of the output check: the plain reference put in the
program's place, computed at a lower precision than the configuration
states (reference/precision.py: bfloat16 -> fp8 products), held by the
same numbers against the reference in float32.  Each number of a cell's
check has to separate this control from the program's own runs.

    python portbench/control.py --workload train-paper-b512 --seeds 11,12,13

prints one JSON line a seed with the control's readings beside the cell's
limits.  Training: the checked steps of a run of that seed (same weights,
same rows, same dropout).  Evaluation: a whole pass over the split.
Serving: the sample of requests a run would check (`sample` videos of the
pool), ranked over the whole catalog.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, generate, harness  # noqa: E402
from portbench.reference import made as R  # noqa: E402
from portbench.reference.precision import lowered  # noqa: E402
from portbench.weights import make_weights  # noqa: E402


def train_control(cell, seed: int, device, precision: str = "fp8", batch: int = 0) -> dict:
    p, flat = cell.traffic, dict(cell.config)
    if batch:
        flat["train.batch_size_train"] = batch
    b = flat["train.batch_size_train"]
    tree = generate.train_tables(p, flat, seed, device)
    rows = generate.epoch_order(p["video_rows"], b, seed, 0)[: p["checked_steps"]]
    batches = [R.gather(tree, torch.as_tensor(r, device=device)) for r in rows]
    del tree
    weights = make_weights(flat, seed, device)
    total = (p["video_rows"] // b) * flat["train.epochs"]
    with lowered("fp32"):
        ref = R.train_steps(weights, flat, batches, seed, total)
    with lowered(precision):
        low = R.train_steps(weights, flat, batches, seed, total)
    grad = check.leaf_norms(low["first_grad"])
    change = check.leaf_norms({n: low["params"][n] - weights[n] for n in low["first_grad"]})
    return check.train(low["losses"], grad, change, ref, weights)


def eval_control(cell, seed: int, device, precision: str = "fp8") -> dict:
    p, flat = cell.traffic, cell.config
    tree = generate.eval_tables(p, flat, seed, device)
    weights = make_weights(flat, seed, device)
    out = {}
    for name, prec in (("ref", "fp32"), ("low", precision)):
        with lowered(prec):
            got = R.evaluation(weights, flat, tree, flat["train.batch_size_val"])
        out[name] = dict(got, sim=check.numpy(got["sim"]), spans=check.numpy(got["spans"]))
    return check.evaluation(out["low"], out["ref"])


def serve_control(cell, seed: int, device, precision: str = "fp8") -> dict:
    p, flat = cell.traffic, cell.config
    feats, smask = generate.catalog(p, flat, seed, device)
    frames, fmask = generate.video_pool(p, flat, seed, device)
    pick = generate.rng(seed, 11).choice(frames.shape[0], size=p["sample"], replace=False)
    weights = make_weights(flat, seed, device)
    fr = torch.as_tensor(frames[pick], device=device)
    fm = torch.as_tensor(fmask[pick], device=device)
    k = p["top_k"]
    out = {}
    for name, prec in (("ref", "fp32"), ("low", precision)):
        with lowered(prec):
            tok, emb = R.music_index(weights, flat, feats, smask.float())
            sims, ft, vemb = R.rank(weights, flat, fr, fm, tok, emb, smask.float())
            out[name] = (tok, emb, sims, ft, vemb)
    tok, emb, sims, ft, vemb = out["low"]
    scores, ids = torch.topk(sims, k, dim=1)
    cand = ids.reshape(-1)
    rep = lambda t: t.repeat_interleave(k, dim=0)
    tracks = torch.unique(torch.cat([cand, torch.as_tensor(
        generate.rng(seed, 12).choice(p["tracks"], size=64), device=device)]))
    with lowered(precision):
        moments, mscores = R.localize(weights, flat, rep(ft), rep(fm), rep(vemb), tok[cand],
                                      smask[cand].float())
    served = {"ids": check.numpy(ids).astype(np.int64), "scores": check.numpy(scores),
              "moments": check.numpy(moments).reshape(-1, k, 2),
              "moment_scores": check.numpy(mscores).reshape(-1, k),
              "emb": check.numpy(emb[tracks]), "tok": check.numpy(tok[tracks])}
    rtok, remb, rsims, rft, rvemb = out["ref"]
    with lowered("fp32"):
        rmom, rms = R.localize(weights, flat, rep(rft), rep(fm), rep(rvemb), rtok[cand],
                               smask[cand].float())
    ref = {"sims": check.numpy(rsims), "moments": check.numpy(rmom).reshape(-1, k, 2),
           "moment_scores": check.numpy(rms).reshape(-1, k), "emb": check.numpy(remb[tracks]),
           "tok": check.numpy(rtok[tracks])}
    return check.serve(served, ref)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="fp8")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(ROOT, harness.with_pending(bench, a.workload), a.workload)
    fn = {"train": train_control, "eval": eval_control,
          "serve": serve_control}[cell.traffic["driver"]]
    for seed in (int(s) for s in a.seeds.split(",")):
        got = fn(cell, seed, device, a.precision)
        print(json.dumps({"workload": a.workload, "seed": seed, "precision": a.precision,
                          "readings": got, "limits": cell.limits}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
