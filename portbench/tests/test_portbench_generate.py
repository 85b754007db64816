"""The traffic generator is a function of the seed: the same seed gives the
same inputs, and every seed the same sizes in another order."""

import numpy as np
import torch

from portbench import generate
from portbench.tests.tiny import TINY
from portbench.harness import load_json
from portbench.tests.tiny import HERE
import os

CFG = dict(load_json(os.path.join(HERE, "configs", "made_paper.json"))["config"], **TINY)
TRAIN = dict(load_json(os.path.join(HERE, "traffic", "train_b512_resident.json")),
             video_rows=60, tracks=12)
SERVE = dict(load_json(os.path.join(HERE, "traffic", "serve_open_idx16k.json")), tracks=20,
             pool=10)
BIG = 2 ** 31 + 12345


def test_train_tables_repeat_from_the_seed():
    a, b = (generate.train_tables(TRAIN, CFG, BIG, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = generate.train_tables(TRAIN, CFG, BIG + 1, "cpu")
    assert not torch.equal(a["vf"], c["vf"])
    for k in ("vm", "mm", "vdur", "mdur"):
        assert torch.equal(a[k].sum(0) if k in ("vdur", "mdur") else a[k].sum(),
                           c[k].sum(0) if k in ("vdur", "mdur") else c[k].sum()), k


def test_epochs_and_codes():
    idx = generate.epoch_order(60, 8, BIG, 0)
    assert idx.shape == (7, 8) and len(set(idx.ravel())) == 56
    assert np.array_equal(idx, generate.epoch_order(60, 8, BIG, 0))
    assert not np.array_equal(idx, generate.epoch_order(60, 8, BIG, 1))
    codes = generate.music_codes(np.arange(60) % 12, idx)
    assert codes.shape == idx.shape and codes.max() < 8


def test_arrivals_same_gaps_every_seed():
    a, b = generate.arrivals(SERVE, 5.0, BIG), generate.arrivals(SERVE, 5.0, BIG + 7)
    assert a.shape == b.shape == (int(np.ceil(SERVE["rate_per_s"] * 5.0)),)
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert np.array_equal(a, generate.arrivals(SERVE, 5.0, BIG))
    assert abs(a[-1] - 5.0) < 0.5


def test_pool_and_catalog_repeat():
    f1, m1 = generate.video_pool(SERVE, CFG, BIG, "cpu")
    f2, m2 = generate.video_pool(SERVE, CFG, BIG, "cpu")
    assert np.array_equal(f1, f2) and np.array_equal(m1, m2)
    c1, k1 = generate.catalog(SERVE, CFG, BIG, "cpu")
    c2, k2 = generate.catalog(SERVE, CFG, BIG, "cpu")
    assert torch.equal(c1, c2) and torch.equal(k1, k2)
