"""The port's span recorder (core/profiling.py::span) and the spans of its
training step and batch gather: nesting, parents and the step's
identifier, the ring's bound and the selection of unprofiled records,
one training step's five spans on the CPU, and the `record_function`
ranges a span opens only while a `torch.profiler` runs."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import profiling
from mgsv_tpu_torch.core.profiling import clear_spans, span, span_durations_ms, span_records
from mgsv_tpu_torch.data.device_data import gather_batch
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32"}
PHASES = ("step.forward", "step.loss", "step.backward", "step.optimizer")


@pytest.fixture(autouse=True)
def empty_rings():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture(scope="module")
def tiny_step():
    cfg = Config.from_overrides(TINY)
    model = MaDe(cfg, torch.Generator().manual_seed(0))
    opt = make_optimizer(model, cfg, 100)
    batch = to_tensors(example_batch(np.random.RandomState(0), cfg, 8), "cpu")
    return make_train_step(model, cfg, opt), opt, batch


def test_nesting_parents_and_the_step_identifier():
    with span("outer", step=7):
        with span("outer.a"):
            with span("outer.a.x"):
                pass
        with span("outer.b"):
            pass
    with span("alone"):
        pass
    (outer,), (a,), (x,), (b,) = (span_records(n) for n in
                                  ("outer", "outer.a", "outer.a.x", "outer.b"))
    assert (outer.parent, a.parent, x.parent, b.parent) == (None, "outer", "outer.a", "outer")
    assert {r.step for r in (outer, a, x, b)} == {7}
    (alone,) = span_records("alone")
    assert alone.parent is None and alone.step is None
    assert outer.t_start_ns <= a.t_start_ns <= x.t_start_ns <= x.t_end_ns <= a.t_end_ns
    assert a.t_end_ns <= b.t_start_ns <= b.t_end_ns <= outer.t_end_ns
    assert not any(r.profiled for r in (outer, a, x, b, alone))


def test_a_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with span("raises", step=1):
            raise ValueError("inside")
    with span("after"):
        pass
    assert len(span_records("raises")) == 1
    assert span_records("after")[0].parent is None


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 5)
    for i in range(12):
        with span("bounded", step=i):
            pass
    got = span_records("bounded")
    assert [r.step for r in got] == list(range(7, 12))
    assert len(span_durations_ms("bounded", 100)) == 5


def test_last_unprofiled_records_are_selected_past_profiled_ones():
    for i in range(4):
        with span("sel", step=i):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(4, 7):
            with span("sel", step=i):
                pass
    recs = span_records("sel")
    assert [r.profiled for r in recs] == [False] * 4 + [True] * 3
    want = [(r.t_end_ns - r.t_start_ns) * 1e-6 for r in recs[1:4]]
    assert span_durations_ms("sel", 3) == pytest.approx(want)
    assert len(span_durations_ms("sel", 10)) == 4
    assert span_durations_ms("absent", 3) == []


def test_one_train_step_records_its_five_spans(tiny_step):
    step, opt, batch = tiny_step
    micro = opt.micro_step
    step(batch)
    (whole,) = span_records("step")
    assert whole.parent is None and whole.step == micro and not whole.profiled
    total = 0
    for name in PHASES:
        (r,) = span_records(name)
        assert r.parent == "step" and r.step == micro
        assert whole.t_start_ns <= r.t_start_ns <= r.t_end_ns <= whole.t_end_ns
        total += r.t_end_ns - r.t_start_ns
    assert 0 < total <= whole.t_end_ns - whole.t_start_ns
    ends = [span_records(n)[0] for n in PHASES]
    assert all(p.t_end_ns <= q.t_start_ns for p, q in zip(ends, ends[1:]))


def test_the_gather_is_a_span():
    tree = {"video_rows": torch.arange(4), "music_rows": torch.arange(4),
            "vm": torch.ones(4, 3, dtype=torch.uint8), "mm": torch.ones(4, 2, dtype=torch.uint8),
            "vf": torch.zeros(4, 3, 5, dtype=torch.float16),
            "mf": torch.zeros(4, 2, 6, dtype=torch.float16),
            "spans": torch.zeros(4, 1, 2), "gt": torch.zeros(4, 1, 2), "mdur": torch.ones(4),
            "vdur": torch.ones(4)}
    gather_batch(tree, torch.tensor([0, 2]))
    (r,) = span_records("input.gather")
    assert r.parent is None and r.step is None and r.t_end_ns >= r.t_start_ns


def test_record_function_ranges_only_while_the_profiler_runs(tiny_step, tmp_path):
    step, _, batch = tiny_step
    step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    step(batch)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("step",) + PHASES:
        assert ranges.count(name) == 1, name
    assert [r.profiled for r in span_records("step")] == [False, True, False]
    steps = [r.step for r in span_records("step")]
    assert steps == sorted(set(steps))
