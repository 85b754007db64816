"""A whole run on the CPU at toy sizes (the look for a card skipped): sound,
it reads correct; with the timed path broken underneath (a step that
leaves the state unchanged, half of the batch left out, an answer altered
where it is produced), it reads not correct.  And without a card the
command prints no result and fails."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench.harness import main
from portbench.tests.tiny import HERE, tiny_tree

ARGS = ["--seed", str(2 ** 31 + 99), "--seconds", "0.5", "--trace", "0"]


def run(tmp_path, capsys, workload, fault=None):
    root, here = tiny_tree(str(tmp_path))
    assert main(["--workload", workload] + ARGS, time.time(), root=root, require_cuda=False,
                device="cpu", fault=fault, here=here) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,fault", [
    ("tiny-train", None), ("tiny-train", "unchanged_state"), ("tiny-train", "half_batch"),
    ("tiny-serve", None), ("tiny-serve", "altered_answer")])
def test_fault_reads_not_correct(tmp_path, capsys, workload, fault):
    got = run(tmp_path, capsys, workload, fault)
    assert got["correct"] is (fault is None), got["checks"]
    assert list(got)[-1] == "checks" and got["attempted"] > 0


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                        "train-paper-b512"] + ARGS, capture_output=True, text=True, env=env,
                       cwd=os.path.dirname(HERE), timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
