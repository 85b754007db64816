"""The reader of step.graph_share.train on hand-made span rings: the share
of the window's steps with a "step.replay" record."""

import collections

import pytest

from portbench.harness import load_module
from portbench.tests.tiny import HERE

READER = load_module(f"{HERE}/metrics/step.graph_share.train.py")


class Ctx:
    def __init__(self, units):
        self.host = {"units": units}


def rings(steps, replayed, traced=()):
    """"step" records for `steps` (then `traced`, with a profiler running)
    and "step.replay" records for `replayed`."""
    step = [("step", None, s, 0, 1, False) for s in steps]
    step += [("step", None, s, 0, 1, True) for s in traced]
    replay = [("step.replay", "step", s, 0, 1, s in traced) for s in replayed]
    out = {"step": collections.deque(step)}
    if replay:
        out["step.replay"] = collections.deque(replay)
    return out


@pytest.mark.parametrize("replayed,want", [
    (range(2, 12), 100.0),                 # every window step replayed
    (range(2, 7), 50.0),                   # half the window
    ([0, 1, 12, 13], 0.0),                 # replays, but none in the window
])
def test_graph_share_of_the_window(monkeypatch, replayed, want):
    from mgsv_tpu_torch.core import profiling
    # steps 0-1 warm up, 2-11 the window, 12-13 traced
    monkeypatch.setattr(profiling, "_rings", rings(range(12), replayed, traced=(12, 13)))
    assert READER.read(Ctx(units=10)) == pytest.approx(want)


def test_a_program_without_the_replay_span_reads_none(monkeypatch):
    from mgsv_tpu_torch.core import profiling
    monkeypatch.setattr(profiling, "_rings", rings(range(12), []))
    assert READER.read(Ctx(units=10)) is None
    assert READER.read(Ctx(units=0)) is None
    monkeypatch.delattr(profiling, "span_records")
    assert READER.read(Ctx(units=10)) is None
