"""The control on the card: the reference at fp8 in the program's place,
at the cells' widths (the training cells at B=64 so that a test run holds
it, the evaluation at its own 2,000 rows), reads past the cells' limits on
three seeds.  Run on the chip with

    python -m pytest -m cuda portbench/tests -q
"""

import os

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import HERE

ROOT = os.path.dirname(HERE)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-paper-b512", "train-q10-b512"])
def test_training_control_fails(device, workload):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(ROOT, bench, workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.train_control(cell, seed, device, batch=64)
        assert any(got[k] > cell.limits[k] for k in got), got


@pytest.mark.cuda
def test_serving_control_fails(device):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(ROOT, harness.with_pending(bench, "serve-paper-idx16k"),
                             "serve-paper-idx16k")
    cell.traffic = dict(cell.traffic, tracks=2048, sample=16)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.serve_control(cell, seed, device)
        assert any(got[k] > cell.limits[k] for k in got), got


@pytest.mark.cuda
def test_eval_control_fails(device):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell(ROOT, bench, "eval-paper-val2000")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        got = control.eval_control(cell, seed, device)
        assert any(got[k] > cell.limits[k] for k in got), got
