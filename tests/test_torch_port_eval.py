"""The port's evaluation (train/step.py::make_eval_step,
eval/similarity.py::xpool_sim_fused, eval/metrics.py, eval/evaluator.py) vs
the JAX package's, at the tiny widths of the verify recipe, in float32 with
dropout off on the CPU.

JAX's fused X-Pool similarity runs its Pallas kernel in interpret mode; the
port's wrappers run their plain versions on CPU tensors (the kernels
themselves are held against those on the card by test_torch_port_cuda.py
and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.data import synthetic as jax_synthetic
from mgsv_tpu.eval import metrics as JM
from mgsv_tpu.eval.evaluator import evaluate as jax_evaluate
from mgsv_tpu.eval.similarity import xpool_similarity_blocked as jax_blocked
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.models.xpool import XPoolTransformer as JaxXPool
from mgsv_tpu.ops.pallas.xpool_sim import xpool_sim_fused as jax_fused
from mgsv_tpu.train.step import make_eval_step as jax_make_eval_step
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.eval import metrics as M
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.eval.similarity import xpool_sim_fused
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import _xpool
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.train.step import make_eval_step

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32",
        "model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0,
        "model.detr_dropout": 0.0}


def _configs():
    return Config.from_overrides(TINY), JaxConfig.from_overrides(TINY)


def _jax_params(jcfg, seed=0):
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(seed))
    # move X-Pool off its identity init, so its similarity carries signal
    rng = np.random.default_rng(seed)
    params = jax.device_get(params)
    params["params"]["xpool_v2m"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        params["params"]["xpool_v2m"])
    return params


def test_eval_step_matches_jax():
    """(a) Every output within atol 1e-5 (the spans in seconds divided by
    max_m_duration first, the scale they are decoded on), the losses within
    rtol 1e-5."""
    cfg, jcfg = _configs()
    batch = example_batch(np.random.RandomState(0), cfg, 8)
    params = _jax_params(jcfg)
    want = jax.device_get(jax_make_eval_step(JaxMaDe(jcfg), jcfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = load_jax_params(MaDe(cfg), params, cfg)
    got = make_eval_step(model, cfg)(to_tensors(batch, "cpu"))
    assert got.keys() == want.keys()
    for k in ("loss", "retrieval_loss", "localization_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k, v in want.items():
        assert not got[k].requires_grad, k
        # spans in seconds: compared on the normalized scale they are decoded from
        scale = cfg.data.max_m_duration if k == "pred_spans_sec" else 1.0
        np.testing.assert_allclose(got[k].numpy() / scale, np.asarray(v) / scale, atol=1e-5,
                                   rtol=0, err_msg=k)


def _xpool_pair(d, seed):
    """A JAX XPoolTransformer's params off identity and the port's module
    holding the same weights."""
    rng = np.random.default_rng(seed)
    zeros = jnp.zeros((2, d))
    params = JaxXPool(d).init(jax.random.PRNGKey(0), zeros, jnp.zeros((2, 3, d)), None)
    params = jax.tree.map(
        lambda x: np.asarray(x + 0.05 * rng.standard_normal(x.shape), np.float32), params)
    state = {}
    _xpool(state, "x", params["params"])
    module = XPoolTransformer(d)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    return params, module


@pytest.mark.parametrize("vc,m,s,masked", [(10, 6, 8, True), (10, 6, 8, False),
                                           (16, 12, 8, True)])
def test_xpool_sim_fused_matches_jax(vc, m, s, masked):
    """(b) The port's xpool_sim_fused on the CPU against JAX's fused kernel
    (interpret mode, blocks 8 x 2, so V and M are ragged) and its blocked
    path, atol 1e-5."""
    d = 32
    params, module = _xpool_pair(d, seed=vc + m)
    rng = np.random.default_rng(vc * m)
    video = rng.standard_normal((vc, d), dtype=np.float32)
    segs = rng.standard_normal((m, s, d), dtype=np.float32)
    mask = None
    if masked:
        mask = (rng.random((m, s)) < 0.6).astype(np.float32)
        mask[:, 0] = 1
    jmask = None if mask is None else jnp.asarray(mask)
    want_fused = jax_fused(jnp.asarray(video), jnp.asarray(segs), jmask, params,
                           block_v=8, block_m=2, interpret=True)
    want_blocked = jax_blocked(JaxXPool(d).apply, params, jnp.asarray(video),
                               jnp.asarray(segs), jmask, block_size=4)
    got = xpool_sim_fused(torch.from_numpy(video), torch.from_numpy(segs),
                          None if mask is None else torch.from_numpy(mask), module)
    assert xps.xpool_sim_eval.launches == 0
    assert got.shape == (vc, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fused), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_blocked), atol=1e-5, rtol=0)


def _tied_sim(seed, n=24, ties=True):
    """A [n, n] float32 similarity with duplicated music ids and, with
    `ties`, exact ties: values on a coarse grid, and duplicate columns."""
    rng = np.random.default_rng(seed)
    ids = [f"m{j}" for j in rng.integers(0, n // 2, n)]
    sim = rng.standard_normal((n, n)).astype(np.float32)
    if ties:
        sim = np.round(sim * 2) / 2                           # many exact ties
        sim[:, 5] = sim[:, 3]                                 # identical columns
        sim[2, :] = 0.5                                       # a row of ties
    return sim, ids


@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False), (3, True)])
def test_device_ranks_match_jax_and_numpy(seed, ties):
    """(c) dedup_rank_device against JAX's _dedup_rank_jax (via
    dedup_rank_device) and the numpy dedup_rank; rect_rank_device against
    JAX's and the numpy rect_rank: equal ranks and top-1 columns."""
    sim, ids = _tied_sim(seed, ties=ties)
    ranks, top1 = M.dedup_rank_device(torch.from_numpy(sim), ids)
    jranks, jtop1 = JM.dedup_rank_device(jnp.asarray(sim), ids)
    np.testing.assert_array_equal(ranks, jranks)
    np.testing.assert_array_equal(top1, jtop1)
    np.testing.assert_array_equal(ranks, M.dedup_rank(sim.astype(np.float64), ids))
    np.testing.assert_array_equal(top1, np.argmax(sim, axis=1))
    cols = sorted(set(ids)) + ["absent"]                      # a track no row uses
    rect = np.random.default_rng(seed).standard_normal((len(ids), len(cols)))
    rect = (np.round(rect * 2) / 2 if ties else rect).astype(np.float32)
    got = M.rect_rank_device(torch.from_numpy(rect), cols, ids)
    np.testing.assert_array_equal(got, JM.rect_rank_device(jnp.asarray(rect), cols, ids))
    np.testing.assert_array_equal(got, M.rect_rank(rect, cols, ids))


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed):
    """(d) recall, IoU and composite metrics exactly equal, for a numpy and
    a tensor similarity."""
    sim, ids = _tied_sim(seed)
    rng = np.random.default_rng(seed)
    iou = np.round(rng.random(len(ids)), 2)
    want, jranks, jres = JM.recall_metrics(sim, ids)
    for s in (sim, torch.from_numpy(sim)):
        got, ranks, res = M.recall_metrics(s, ids)
        assert got == want and res == jres
        np.testing.assert_array_equal(ranks, jranks)
    assert M.iou_metrics(iou) == JM.iou_metrics(iou)
    assert M.composite_metrics(jranks, iou) == JM.composite_metrics(jranks, iou)
    cols = sorted(set(ids))
    assert M.recall_metrics_rect(sim[:, :len(cols)], cols, ids)[0] == \
        JM.recall_metrics_rect(sim[:, :len(cols)], cols, ids)[0]


def test_evaluate_matches_jax(tmp_path):
    """(e) evaluate() as a whole against JAX's, with the fused similarity
    and without, on one synthetic dataset of 44 rows at batch 16 (the final
    batch padded with 4 rows).  No row's GT similarity lies within 1e-5 of
    another track's, so ranks must be equal; retrieval metrics equal, IoU
    metrics within 1e-5, loss within rtol 1e-5."""
    cfg, jcfg = _configs()
    root = str(tmp_path / "data")
    synthetic.generate(root, n_rows=44, data_cfg=cfg.data, seed=3, family_size=2)
    data = synthetic.open_synthetic(root, cfg.data)
    jdata = jax_synthetic.open_synthetic(root, jcfg.data)
    params = _jax_params(jcfg, seed=1)
    model = load_jax_params(MaDe(cfg), params, cfg)
    for fused in (True, False):
        got = evaluate(model, data, cfg, batch_size=16, use_fused_sim=fused)
        want = jax_evaluate(JaxMaDe(jcfg), params, jdata, jcfg, batch_size=16,
                            use_fused_sim=fused)
        sim = got["sim"].numpy()
        codes = np.unique(got["music_ids"], return_inverse=True)[1]
        same = codes[:, None] == codes[None, :]
        gt = np.where(same, sim, -np.inf).max(axis=1)
        assert np.abs(np.where(same, np.inf, sim - gt[:, None])).min() > 1e-5
        np.testing.assert_array_equal(got["ranks"], want["ranks"])
        assert got["retrieval"] == want["retrieval"]
        assert got["ret_results"] == want["ret_results"]
        assert got["video_ids"] == want["video_ids"] and got["music_ids"] == want["music_ids"]
        for key in ("localization", "composite"):
            for k, v in want[key].items():
                np.testing.assert_allclose(got[key][k], v, atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["ious"], want["ious"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["pred_spans"] / cfg.data.max_m_duration,
                                   want["pred_spans"] / cfg.data.max_m_duration, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert xps.xpool_sim_eval.launches == 0
