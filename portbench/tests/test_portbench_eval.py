"""The evaluation cell on the CPU at toy sizes (the look for a card
skipped): a whole run reads correct with all three numbers and prints
`eval_device_s` (the device clock's busy seconds a pass; the CPU's
operators here) and, traced, `eval.epoch_s.eval`; each planted fault fails its number; the split is a
function of the seed with a track of its own a row; the pass's frozen FLOP
count is the sum of its parts; #4's table counts one call a pass."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import flops, generate
from portbench.harness import load_json, load_module, main
from portbench.tests.tiny import HERE, TINY, tiny_tree

SEED = 2 ** 31 + 77
CFG = dict(load_json(os.path.join(HERE, "configs", "made_paper.json"))["config"], **TINY)
MIX = load_json(os.path.join(HERE, "traffic", "eval_val_resident.json"))


def run(tmp_path, capsys, fault=None, trace=0):
    root, here = tiny_tree(str(tmp_path))
    argv = ["--workload", "tiny-eval", "--seed", str(SEED), "--seconds", "0.3",
            "--trace", str(trace)]
    assert main(argv, time.time(), root=root, require_cuda=False, device="cpu", fault=fault,
                here=here) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_eval_run_reads_correct(tmp_path, capsys):
    got, err = run(tmp_path, capsys)
    assert got["correct"] is True and got["attempted"] > 0 and got["failed"] == 0
    assert set(got["checks"]) == {"sim_gap", "span_gap_s", "ret_loss_gap"}
    assert list(got)[-1] == "checks"
    assert got["metrics"]["eval_device_s"]["unit"] == "s"
    assert got["metrics"]["eval_device_s"]["value"] > 0
    assert set(got["metrics"]) == {"eval_device_s", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ret_loss_gap ")


def test_eval_traced_run_reads_its_pass_share(tmp_path, capsys):
    got, _ = run(tmp_path, capsys, trace=1)
    assert got["correct"] is True
    assert 0 < got["metrics"]["eval.mfu.eval"]["value"] < 100
    assert got["metrics"]["eval.epoch_s.eval"]["value"] > 0


@pytest.mark.parametrize("fault,numbers", [
    ("dual_only", ["sim_gap"]), ("half_rows", ["sim_gap", "span_gap_s", "ret_loss_gap"])])
def test_eval_fault_fails_its_number(tmp_path, capsys, fault, numbers):
    got, _ = run(tmp_path, capsys, fault)
    assert got["correct"] is False
    for k in numbers:
        assert got["checks"][k]["value"] > got["checks"][k]["limit"], (k, got["checks"])


def test_eval_tables_repeat_from_the_seed():
    mix = dict(MIX, rows=30, tracks=30)
    a, b = (generate.eval_tables(mix, CFG, SEED, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(a["music_rows"].tolist()) == list(range(30))
    c = generate.eval_tables(mix, CFG, SEED + 1, "cpu")
    assert torch.equal(a["vdur"].sort().values, c["vdur"].sort().values)
    assert not torch.equal(a["vf"], c["vf"])


def test_eval_pass_flops_is_the_sum_of_its_parts():
    cfg = load_json(os.path.join(HERE, "configs", "made_paper.json"))["config"]
    got = flops.eval_pass_flops(cfg, 2000, 40)
    d, s = 256, 96
    corpus = 2 * 2000 * 2000 * d + 2 * 2000 * d * d + 4 * 2000 * s * d * d \
        + flops.xpool_pair_flops(2000, 2000, s, d)
    assert got["forward"] == 50 * flops.train_step_flops(cfg, 40)["forward"]
    assert got["corpus"] == corpus and got["pass"] == got["forward"] + got["corpus"]
    assert round(got["pass"] / 1e12, 3) == 3.208
    # a split that does not fill its last batch pays for the padded batch
    assert flops.eval_pass_flops(cfg, 2001, 40)["forward"] == 51 * got["forward"] / 50


class Ctx:
    def __init__(self, calls, units, rows=2000):
        self.cell = type("Cell", (), {"traffic": {"rows": rows}})()
        self.trace_units, self._calls = units, calls

    def launches(self, path):
        return self._calls

    def dim(self, key):
        return {"s": 96, "d": 256}[key]


def test_xpool_eval_table_counts_one_call_a_pass():
    table = load_module(os.path.join(HERE, "kernels", "xpool_sim_eval.py"))
    one = table.least_s(Ctx(1, 1))
    assert one == pytest.approx(flops.xpool_pair_flops(2000, 2000, 96, 256) / 495e12)
    assert table.least_s(Ctx(2, 2)) == 2 * one
    assert table.least_s(Ctx(0, 2)) == 0.0
    assert np.isnan(table.least_s(Ctx(3, 2)))


class Event:
    def __init__(self, device, start, end, annotation=False):
        self.device, self.start, self.end, self.annotation = device, start, end, annotation

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_device_clock_counts_the_union_of_device_work():
    from portbench.trace import busy_seconds
    gpu, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [Event(gpu, 0, 10), Event(gpu, 5, 20), Event(gpu, 30, 40), Event(gpu, 40, 45),
              Event(gpu, 0, 100, annotation=True), Event(cpu, 0, 100), Event(cpu, 50, 60),
              Event(cpu, 55, 70), Event(cpu, 0, 200, annotation=True)]
    assert busy_seconds(events, on_device=True) == pytest.approx(35e-9)
    assert busy_seconds(events[6:], on_device=False) == pytest.approx(20e-9)
    assert busy_seconds([], on_device=True) == 0.0
