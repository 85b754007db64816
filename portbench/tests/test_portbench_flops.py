"""The benchmark's frozen FLOP count equals the program's today."""

import dataclasses

import pytest

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import flops as port_flops
from portbench import flops


def flat(cfg):
    return {f"{s}.{k}": v for s in ("data", "model", "loss", "train")
            for k, v in dataclasses.asdict(getattr(cfg, s)).items()}


@pytest.mark.parametrize("queries,tflop", [(1, 1.959), (10, 2.169)])
def test_train_step_count(queries, tflop):
    cfg = Config.from_overrides({"model.num_moment_queries": queries})
    got = flops.train_step_flops(flat(cfg), 512)["train_step"]
    assert round(got / 1e12, 3) == tflop
    assert got == port_flops.train_step_flops(cfg, 512)["train_step"]


def test_serve_query_count_grows_with_the_catalog():
    c = flat(Config())
    small, big = (flops.serve_query_flops(c, 32, 8, m) for m in (4096, 16384))
    assert 2.0 < big / small < 4.0
