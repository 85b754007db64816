"""The plain reference agrees with the port's plain path on the CPU at toy
widths: three training steps with dropout on (losses, the first clipped
gradient, the weights' change), and a served query (index, scores,
moments)."""

import dataclasses

import numpy as np
import pytest
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step
from portbench.reference import made as R
from portbench.tests.tiny import TINY
from portbench.weights import make_weights


def setup(**over):
    cfg = Config.from_overrides(dict(TINY, **{"train.seed": 2 ** 31 + 5}, **over))
    flat = {f"{s}.{k}": v for s in ("data", "model", "loss", "train")
            for k, v in dataclasses.asdict(getattr(cfg, s)).items()}
    weights = make_weights(flat, 11, "cpu")
    model = MaDe(cfg)
    model.load_state_dict(weights, strict=True)
    return cfg, flat, weights, model


def batches(flat, n=3, b=8):
    d = R.dims(flat)
    g = torch.Generator().manual_seed(3)
    out = []
    for _ in range(n):
        fm = (torch.rand(b, d["f"], generator=g) < 0.8).float()
        sm = (torch.rand(b, d["s"], generator=g) < 0.8).float()
        fm[:, 0] = sm[:, 0] = 1
        cw = torch.rand(b, 1, 2, generator=g) * 0.4 + 0.1
        out.append({"frame_feats": torch.randn(b, d["f"], d["vit"], generator=g) * fm[..., None],
                    "frame_mask": fm, "segment_mask": sm,
                    "segment_feats": torch.randn(b, d["s"], d["ast"], generator=g) * sm[..., None],
                    "spans_target": cw, "gt_moment": cw * 100, "m_duration": torch.full((b,), 200.0),
                    "v_duration": torch.full((b,), 12.0)})
    return out


@pytest.mark.parametrize("over", [{}, {"model.num_moment_queries": 10,
                                       "model.fused_temporal": True}], ids=["paper", "q10"])
def test_training_steps(over):
    cfg, flat, weights, model = setup(**over)
    opt = make_optimizer(model, cfg, 500)
    step = make_train_step(model, cfg, opt)
    data = batches(flat)
    losses = []
    for i, b in enumerate(data):
        losses.append(float(step(b)["loss"]))
        if i == 0:
            grad = {n: float((mu / 0.1).norm()) for n, (mu, _) in opt.state.items()}
    ref = R.train_steps(weights, flat, data, cfg.train.seed, 500)
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    for n, g in ref["first_grad"].items():
        assert abs(grad[n] - float(g.norm())) <= 1e-4 * max(float(g.norm()), 1e-3), n
    params = dict(model.named_parameters())
    med = float(np.median([float(g.norm()) for g in ref["first_grad"].values()]))
    for n, g in ref["first_grad"].items():
        if float(g.norm()) < 1e-3 * med:     # moves by round-off alone (a key's bias)
            continue
        a = float((params[n].detach() - weights[n]).norm())
        b = float((ref["params"][n] - weights[n]).norm())
        assert abs(a - b) <= 1e-2 * max(b, 1e-6), n


def test_served_query():
    cfg, flat, weights, model = setup()
    d = R.dims(flat)
    g = torch.Generator().manual_seed(4)
    m = 24
    smask = (torch.arange(d["s"])[None] < torch.randint(1, d["s"] + 1, (m, 1), generator=g)).float()
    feats = torch.randn(m, d["s"], d["ast"], generator=g) * smask[..., None]
    index = build_music_index(model, [str(i) for i in range(m)], feats.numpy(), smask.numpy())
    engine = RetrievalEngine(model, cfg, index)
    fmask = (torch.arange(d["f"])[None] < torch.tensor([[3], [12], [7]])).float()
    frames = torch.randn(3, d["f"], d["vit"], generator=g) * fmask[..., None]
    got = engine.query(frames.numpy(), fmask.numpy(), top_k=5)
    tok, emb = R.music_index(weights, flat, feats, smask)
    assert np.allclose(index.seg_tokens, tok.numpy(), atol=1e-5)
    sims, ft, vemb = R.rank(weights, flat, frames, fmask, tok, emb, smask)
    for i, r in enumerate(got):
        ids = [int(t) for t in r["music_ids"]]
        assert np.allclose(r["retrieval_scores"], sims[i, ids].numpy(), atol=1e-5)
        assert np.allclose(sorted(r["retrieval_scores"], reverse=True),
                           torch.topk(sims[i], 5).values.numpy(), atol=1e-5)
        rep = lambda t: t[i:i + 1].expand(len(ids), *t.shape[1:])
        mom, score = R.localize(weights, flat, rep(ft), rep(fmask), rep(vemb), tok[ids],
                                smask[ids])
        assert np.allclose(r["moments"], mom.numpy(), atol=1e-3)
        assert np.allclose(r["moment_scores"], score.numpy(), atol=1e-5)
