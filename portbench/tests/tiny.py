"""A benchmark tree at toy sizes for the CPU tests: the real portbench
files copied under a temporary root, with tiny configurations, mixes and a
BENCHMARK.json of their cells added."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.temporal_mlp_dim": 64,
        "model.detr_ffn_dim": 64, "model.detr_dec_layers": 2, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "train.batch_size_train": 8, "train.epochs": 2,
        "model.compute_dtype": "float32"}


def tiny_tree(tmp: str, q10: bool = False, rate: float = 40.0) -> tuple:
    """(root, portbench dir) of a toy benchmark with the cells tiny-train,
    tiny-serve and tiny-eval."""
    here = os.path.join(tmp, "portbench")
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    name = "made_q10" if q10 else "made_paper"
    doc = json.load(open(os.path.join(HERE, "configs", name + ".json")))
    doc["config"].update(TINY)
    json.dump(doc, open(os.path.join(here, "configs", "tiny.json"), "w"))
    train = json.load(open(os.path.join(HERE, "traffic", "train_b512_resident.json")))
    train.update(video_rows=40, tracks=10, checked_steps=3, warm_steps=1, trace_steps=2)
    json.dump(train, open(os.path.join(here, "traffic", "tiny_train.json"), "w"))
    serve = json.load(open(os.path.join(HERE, "traffic", "serve_open_idx16k.json")))
    serve.update(tracks=40, pool=16, rate_per_s=rate, sample=6, clients=8, trace_seconds=0.3,
                 warm_buckets=[1, 2, 4, 8], max_batch=8)
    json.dump(serve, open(os.path.join(here, "traffic", "tiny_serve.json"), "w"))
    ev = json.load(open(os.path.join(HERE, "traffic", "eval_val_resident.json")))
    ev.update(rows=44, tracks=44, warm_passes=1, trace_passes=1)
    json.dump(ev, open(os.path.join(here, "traffic", "tiny_eval.json"), "w"))
    lim = {"sim_gap": 1e-4, "span_gap_s": 1e-3, "ret_loss_gap": 1e-4}
    json.dump(lim, open(os.path.join(here, "limits", "tiny-eval.json"), "w"))
    lim = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-2}
    json.dump(lim, open(os.path.join(here, "limits", "tiny-train.json"), "w"))
    lim = {"index_gap": 1e-4, "rank_gap": 1e-4, "score_gap": 1e-4, "moment_gap_s": 1e-3,
           "moment_score_gap": 1e-4}
    json.dump(lim, open(os.path.join(here, "limits", "tiny-serve.json"), "w"))
    bench = harness.with_pending(
        json.load(open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"))),
        "serve-paper-idx16k")
    bench["configs"] = [{"name": "tiny", "source": "toy", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "toy"}]
    bench["workloads"] = [
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "t"},
        {"name": "tiny-serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1, "why": "s"},
        {"name": "tiny-eval", "config": "tiny", "traffic": "tiny_eval", "chips": 1, "why": "e"}]
    rename = {"train-paper-b512": "tiny-train", "train-q10-b512": "tiny-train",
              "serve-paper-idx16k": "tiny-serve", "eval-paper-val2000": "tiny-eval"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({rename[w] for w in m["workloads"]})
    json.dump(bench, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return tmp, here
