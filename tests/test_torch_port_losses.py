"""The port's losses, matcher and span math (ops/losses.py, ops/matcher.py,
ops/spans.py) vs the JAX package's, on the same numpy inputs in float32.

Values and gradients agree to atol 1e-5, rtol 1e-5: both sides run the same
float32 formulas and differ by summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.ops import losses as jl
from mgsv_tpu.ops import matcher as jm
from mgsv_tpu.ops import spans as js
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.ops import losses as tl
from mgsv_tpu_torch.ops import matcher as tm
from mgsv_tpu_torch.ops import spans as ts

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL, err_msg=name)


def _se_spans(rng, *shape):
    start = rng.random(shape, dtype=np.float32)
    return np.stack([start, start + rng.random(shape, dtype=np.float32)], axis=-1)


@pytest.mark.parametrize("fn", ["temporal_iou", "generalized_temporal_iou"])
def test_pairwise_span_iou_matches_jax(fn):
    rng = np.random.default_rng(0)
    a, b = _se_spans(rng, 5), _se_spans(rng, 7)
    b[0] = a[0]                                       # identical pair: IoU 1
    b[1] = [a[1, 1] + 1, a[1, 1] + 2]                 # disjoint pair: IoU 0
    got = getattr(ts, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(js, fn)(jnp.asarray(a), jnp.asarray(b))
    pairs = zip(got, want) if fn == "temporal_iou" else [(got, want)]   # (iou, union)
    for g, w in pairs:
        _close(g, w, fn)


def test_elementwise_giou_and_eval_iou_match_jax():
    rng = np.random.default_rng(1)
    a, b = _se_spans(rng, 4, 3), _se_spans(rng, 4, 3)
    _close(ts.elementwise_temporal_giou(torch.from_numpy(a), torch.from_numpy(b)),
           js.elementwise_temporal_giou(jnp.asarray(a), jnp.asarray(b)))
    gt = np.array([[10, 30], [50, 40], [0, 240], [100, 120]], np.float32)   # one gt_st >= gt_ed
    pred = np.array([[-5, 20], [45, 60], [100, 300], [130, 140]], np.float32)
    dur = np.array([200, 200, 180, 150], np.float32)
    _close(ts.eval_iou_batch(*map(torch.from_numpy, (gt, dur, pred)), 240.0),
           js.eval_iou_batch(*map(jnp.asarray, (gt, dur, pred)), 240.0))


@pytest.mark.parametrize("codes", [False, True])
def test_retrieval_losses_match_jax(codes):
    rng = np.random.default_rng(2)
    n, d = 9, 16
    x, y = (rng.standard_normal((n, d), dtype=np.float32) for _ in range(2))
    scale = np.float32(np.log(1 / 0.07))
    music = np.array([0, 1, 1, 2, 3, 3, 3, 4, 5]) if codes else None

    def jax_losses(x_, y_, s_):
        sims = jl.cosine_sim_matrix(x_, y_)
        return (jl.clip_loss(sims, s_)
                + 2.0 * jl.info_nce_loss(sims, s_, None if music is None else jnp.asarray(music)))

    want, want_grads = jax.value_and_grad(jax_losses, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale))
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    st = torch.tensor(scale, requires_grad=True)
    sims = tl.cosine_sim_matrix(xt, yt)
    got = tl.clip_loss(sims, st) + 2.0 * tl.info_nce_loss(
        sims, st, None if music is None else torch.from_numpy(music))
    got.backward()
    _close(got.item(), want)
    for g, w in zip((xt.grad, yt.grad, st.grad), want_grads):
        _close(g, w)


def _detr_outputs(rng, layers, b, q, t, dc, frames):
    logits = rng.standard_normal((layers, b, q, 2), dtype=np.float32)
    spans = 1 / (1 + np.exp(-rng.standard_normal((layers, b, q, 2), dtype=np.float32)))
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    pq = unit(rng.standard_normal((layers, b, q, dc), dtype=np.float32))
    vm = unit(rng.standard_normal((b, frames, dc), dtype=np.float32))
    tgt = np.stack([rng.uniform(0.2, 0.8, (b, t)), rng.uniform(0.05, 0.3, (b, t))],
                   axis=-1).astype(np.float32)
    if t > 1:
        tgt[0, 1:, 1] = 0                             # padded targets: width 0
        tgt[1, 0, 1] = 0
    return logits, spans, pq, vm, tgt


@pytest.mark.parametrize("targets,overrides", [
    (1, {}),                                          # the paper configuration
    (3, {}),                                          # #Q=1 vs several targets
    (1, {"loss.aux_loss": False, "loss.eos_coef": 0.3}),
    (2, {"loss.contrastive_align_loss": False, "loss.l1_loss": False}),
])
def test_set_criterion_matches_jax(targets, overrides):
    rng = np.random.default_rng(3 + targets)
    cfg, jcfg = Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)
    logits, spans, pq, vm, tgt = _detr_outputs(rng, 3, 6, 1, targets, 8, 5)
    align = cfg.loss.contrastive_align_loss

    def jax_fn(lg, sp, pq_, vm_):
        return jl.set_criterion(lg, sp, pq_ if align else None, vm_ if align else None,
                                jnp.asarray(tgt), jcfg.loss)

    (want, want_log), vjp = jax.vjp(jax_fn, *map(jnp.asarray, (logits, spans, pq, vm)))
    want_grads = vjp((jnp.ones(()), jax.tree.map(jnp.zeros_like, want_log)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (logits, spans, pq, vm)]
    got, got_log = tl.set_criterion(ins[0], ins[1], ins[2] if align else None,
                                    ins[3] if align else None, torch.from_numpy(tgt), cfg.loss)
    got.backward()
    _close(got.item(), want)
    assert got_log.keys() == want_log.keys()
    for k in want_log:
        _close(got_log[k].detach(), want_log[k], k)
    for name, g, w in zip(("logits", "spans", "proj_queries", "proj_vid_mem"),
                          (t.grad for t in ins), want_grads):
        _close(np.zeros_like(w) if g is None else g, w, name)


@pytest.mark.parametrize("targets", [1, 4])
def test_one_query_matcher_matches_jax(targets):
    rng = np.random.default_rng(7)
    logits, spans, _, _, tgt = _detr_outputs(rng, 1, 6, 1, targets, 4, 3)
    mask = tgt[..., 1] != 0
    cfg, jcfg = Config(), JaxConfig()
    got = tm.hungarian_match(torch.from_numpy(logits[0]), torch.from_numpy(spans[0]),
                             torch.from_numpy(tgt), torch.from_numpy(mask), cfg.loss)
    want = jm.hungarian_match(jnp.asarray(logits[0]), jnp.asarray(spans[0]), jnp.asarray(tgt),
                              jnp.asarray(mask), jcfg.loss)
    np.testing.assert_array_equal(got.tgt_to_pred.numpy(), np.asarray(want.tgt_to_pred))
    np.testing.assert_array_equal(got.pair_valid.numpy(), np.asarray(want.pair_valid))
    _close(tm.matcher_cost(torch.from_numpy(logits[0]), torch.from_numpy(spans[0]),
                           torch.from_numpy(tgt), torch.from_numpy(mask), cfg.loss),
           jm.matcher_cost(jnp.asarray(logits[0]), jnp.asarray(spans[0]), jnp.asarray(tgt),
                           jnp.asarray(mask), jcfg.loss))


def test_matcher_refuses_several_queries():
    """Three queries: refused until the batched LSAP (ops/lsap.py) was
    ported; now the matcher takes them and gives JAX's assignment on the
    same inputs, padded targets included."""
    rng = np.random.default_rng(8)
    logits, spans, _, _, tgt = _detr_outputs(rng, 1, 2, 3, 2, 4, 3)
    mask = tgt[..., 1] != 0
    got = tm.hungarian_match(torch.from_numpy(logits[0]), torch.from_numpy(spans[0]),
                             torch.from_numpy(tgt), torch.from_numpy(mask), Config().loss)
    want = jm.hungarian_match(jnp.asarray(logits[0]), jnp.asarray(spans[0]), jnp.asarray(tgt),
                              jnp.asarray(mask), JaxConfig().loss)
    np.testing.assert_array_equal(got.pair_valid.numpy(), np.asarray(want.pair_valid))
    np.testing.assert_array_equal(got.tgt_to_pred.numpy(), np.asarray(want.tgt_to_pred))
