"""The readers of the program's spans: device time and host syncs put down
to a span by time, on any host thread, on a hand-made Chrome trace; and a
whole tiny training run on the CPU whose `--trace 1` line holds the five
host-ms metrics, the four phases adding up to the step's host time."""

import json
import time

import pytest

from portbench import spans
from portbench.harness import load_module, main
from portbench.tests.tiny import HERE, tiny_tree
from portbench.trace import Summary

MAIN, AUTOGRAD = 1, 2


def ann(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur):
    return {"cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


EVENTS = [
    ann("step", 100, 200), ann("step.forward", 105, 40), ann("step.backward", 150, 100),
    ann("step.optimizer", 260, 30),
    launch(1, 110), kernel(1, 115, 10),                  # forward
    launch(2, 160, tid=AUTOGRAD), kernel(2, 170, 20),    # backward, the autograd thread
    launch(3, 200, tid=AUTOGRAD), kernel(3, 210, 5),
    launch(4, 270), kernel(4, 275, 7),                   # optimizer
    launch(5, 50), kernel(5, 55, 30),                    # outside every span
    launch(6, 280, name="cudaStreamSynchronize"),        # a sync inside "step"
    launch(7, 320, name="cudaStreamSynchronize"),        # the loss read, outside it
    launch(8, 140, name="cudaMemcpyAsync"),              # not blocking by itself
]


class Ctx:
    def __init__(self, events, units=1):
        self.trace, self.trace_units, self.host = Summary(events, 400e-6), units, {}


def test_device_time_by_span_across_threads():
    t = Summary(EVENTS, 400e-6)
    assert spans.span_device_s(t, "step.forward") == pytest.approx(10e-6)
    assert spans.span_device_s(t, "step.backward") == pytest.approx(25e-6)
    assert spans.span_device_s(t, "step.optimizer") == pytest.approx(7e-6)
    assert spans.span_device_s(t, "step") == pytest.approx(42e-6)   # not kernel 5
    assert t.range_device_s("step.backward") == 0.0      # its own thread only
    assert spans.span_device_s(t, "step.loss") is None


def test_host_syncs_inside_the_step_only():
    t = Summary(EVENTS, 400e-6)
    assert spans.host_syncs(t, "step") == 1
    two = EVENTS + [ann("step", 400, 100), launch(9, 450, tid=AUTOGRAD, name="cudaMemcpy"),
                    launch(10, 460, name="cudaDeviceSynchronize"), launch(11, 470),
                    kernel(11, 480, 1)]
    reader = load_module(f"{HERE}/metrics/step.host_syncs.train.py")
    assert reader.read(Ctx(two, units=2)) == 1.5


@pytest.mark.parametrize("phase,want", [("forward", 10e-3), ("loss", None),
                                        ("backward", 25e-3), ("optimizer", 7e-3)])
def test_device_readers(phase, want):
    reader = load_module(f"{HERE}/metrics/step.{phase}_device_ms.train.py")
    got = reader.read(Ctx(EVENTS))
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", ["step.forward_device_ms.train", "step.host_syncs.train",
                                  "step.loss_host_ms.train", "input.gather_host_ms.train"])
def test_a_trace_without_spans_reads_none(name):
    """A program without the spans (and a run on the CPU) reads nothing."""
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"]
    reader = load_module(f"{HERE}/metrics/{name}.py")
    assert reader.read(Ctx(bare)) is None
    assert reader.read(Ctx([])) is None


def test_host_readers_without_the_program_s_spans(monkeypatch):
    """A name the ring never saw, and a program without the ring, read
    nothing."""
    from mgsv_tpu_torch.core import profiling
    ctx = Ctx([])
    ctx.host = {"units": 3}
    reader = load_module(f"{HERE}/metrics/step.forward_host_ms.train.py")
    monkeypatch.setattr(profiling, "_rings", {})
    assert reader.read(ctx) is None
    monkeypatch.delattr(profiling, "span_durations_ms")
    assert reader.read(ctx) is None


HOST = ["input.gather_host_ms.train", "step.forward_host_ms.train", "step.loss_host_ms.train",
        "step.backward_host_ms.train", "step.optimizer_host_ms.train"]


def test_tiny_training_run_prints_the_host_spans(tmp_path, capsys):
    root, here = tiny_tree(str(tmp_path))
    args = ["--workload", "tiny-train", "--seed", str(2 ** 31 + 5), "--seconds", "1.0",
            "--trace", "1"]
    assert main(args, time.time(), root=root, require_cuda=False, device="cpu",
                here=here) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    for name in HOST:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms", name
    phases = sum(got[n]["value"] for n in HOST[1:])
    assert 0.8 <= phases / got["step.host_ms.train"]["value"] <= 1.05
