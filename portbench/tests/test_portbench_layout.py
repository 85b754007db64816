"""The benchmark is driven by data: cells, configurations, mixes, limits,
per-layer readers and kernel tables are found by name, and a new one is a
new file."""

import json
import os
import re
import shutil

from portbench import harness
from portbench.tests.tiny import HERE

ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, b, w["name"])
        assert cell.traffic["driver"] in ("train", "serve", "eval")
        assert os.path.exists(os.path.join(HERE, "drivers", cell.traffic["driver"] + ".py"))
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]


def test_contract_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in b["configs"]:
        doc = json.load(open(os.path.join(ROOT, c["file"])))
        assert doc["reduced"] == c["reduced"] == []
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])


def test_a_metric_file_added_is_read_without_an_edit(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "metrics" / "extra.count.train.py").write_text(
        "def read(ctx):\n    return ctx.host['steps'] * 2.0\n")
    b = bench()
    b["per_layer"].append({"name": "extra.count.train", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "train step",
                           "moves": "train_clips_per_s", "workloads": ["train-paper-b512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell(str(tmp_path), b, "train-paper-b512", str(here))
    assert "extra.count.train" in [m["name"] for m in cell.per_layer]
    reader = harness.load_module(str(here / "metrics" / "extra.count.train.py"))

    class Ctx:
        host = {"steps": 21}

    assert reader.read(Ctx()) == 42.0


def test_kernel_tables_name_the_port_kernels():
    tables = harness.KernelTables()
    assert tables.is_port("void (anonymous namespace)::wg_gemm_kernel<3>(GemmParams)")
    assert tables.is_port("(anonymous namespace)::xpool_pair_kernel<true>(FwdParams)")
    assert not tables.is_port("void at::native::reduce_kernel<512, 1>(int)")
    assert not tables.is_port("void (anonymous namespace)::my_attention_kernel(float*)")
