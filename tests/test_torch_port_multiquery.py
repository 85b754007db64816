"""Multi-query detection (model.num_moment_queries > 1) in the port against
the JAX package, on the CPU at tiny widths.

The #Q>1 matcher (ops/matcher.py's LSAP branch) against JAX's
`hungarian_match`; a MaDe with three moment queries: its forward, loss and
one float32 train step, with the plain decoder and with `fused_decoder=
True` (the decoder-layer kernel's plain version on the CPU), against JAX's
MaDe (whose DetrTransformer runs the plain decoder; its fused twin computes
the same function); `evaluate` and the serving engine at Q=3; and the
refusal of a training call that would drop out in a layer without dropout.

The port's LSAP is exact (float64 potentials, ops/lsap.py), where JAX's
float32 solver misses SciPy's optimum on some costs
(tests/test_torch_port_lsap.py).  So the matcher is held to JAX's
assignment wherever JAX's is optimal and to SciPy's optimum everywhere,
and the comparisons of losses, steps and evaluations run JAX with SciPy's
solver (the reference's matcher) in place of its own (`scipy_jax_lsap`):
the port is held to the function JAX means to compute.

Tolerances are those of the Q=1 tests: tests/test_torch_port_train.py for
the step (loss rtol 1e-5; gradients atol 1e-5 + rtol 1e-4),
tests/test_torch_port_eval.py for `evaluate` (ranks and retrieval metrics
equal, IoU metrics 1e-5) and tests/test_torch_port_serve.py for the engine
(same ids, scores 1e-4, moments 1e-3 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from mgsv_tpu.config import Config as JaxConfig, DataConfig, LossConfig as JaxLossConfig
from mgsv_tpu.config import ModelConfig
from mgsv_tpu.data import synthetic as jax_synthetic
from mgsv_tpu.eval.evaluator import evaluate as jax_evaluate
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.ops import lsap as jax_lsap
from mgsv_tpu.ops.matcher import hungarian_match as jax_hungarian_match
from mgsv_tpu.ops.matcher import matcher_cost as jax_matcher_cost
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu_torch.config import Config, LossConfig
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops import lsap
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.matcher import hungarian_match, matcher_cost
from mgsv_tpu_torch.serve import engine as tengine
from mgsv_tpu_torch.train.objective import total_loss
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_eval_step, make_train_step

Q = 3
TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32",
        "model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0,
        "model.num_moment_queries": Q}


def _configs(**extra):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)


def _jax_params(jcfg, seed=0):
    """JAX MaDe weights, every one moved off its init (so the Q query
    embeddings, the decoder and the heads all carry signal)."""
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.device_get(jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(np.shape(x))).astype(np.float32), params)


def tm_cost(logits, spans, tgt, mask) -> np.ndarray:
    """The port's matcher cost [B, Q, T], float64."""
    return matcher_cost(*map(torch.from_numpy, (logits, spans, tgt, mask)),
                        LossConfig()).double().numpy()


def _scipy_col_to_row(cost):
    """SciPy's assignment of each [R, C] cost as col_to_row [B, C] (R for
    an unmatched column): the reference's matcher."""
    cost = np.asarray(cost, np.float64)
    out = np.full(cost.shape[:1] + cost.shape[2:], cost.shape[1], np.int32)
    for b, c in enumerate(cost):
        ri, ci = linear_sum_assignment(c)
        out[b, ci] = ri
    return out


@pytest.fixture
def scipy_jax_lsap(monkeypatch):
    """JAX's matcher with SciPy's solver in place of its float32 one."""
    def solve_batch(cost):
        shape = jax.ShapeDtypeStruct(cost.shape[:1] + cost.shape[2:], jnp.int32)
        return jax.pure_callback(_scipy_col_to_row, shape, jax.lax.stop_gradient(cost),
                                 vmap_method="sequential")

    monkeypatch.setattr(jax_lsap, "solve_batch", solve_batch)


@pytest.mark.parametrize("num_targets,seed", [(1, 0), (2, 1), (4, 2)])
def test_matcher_matches_jax(num_targets, seed):
    """The cost, its LSAP and the validity of each pair, with padded
    (zero-width) targets, at Q = 5: SciPy's optimum in every sample, and
    JAX's assignment wherever JAX's float32 solver finds the optimum."""
    rng = np.random.default_rng(seed)
    b, q = 16, 5
    logits = rng.standard_normal((b, q, 2)).astype(np.float32)
    spans = rng.uniform(0.05, 0.95, (b, q, 2)).astype(np.float32)
    tgt = rng.uniform(0.05, 0.95, (b, num_targets, 2)).astype(np.float32)
    tgt[::3, -1, 1] = 0.0                                 # padded targets
    mask = tgt[..., 1] != 0
    jargs = tuple(map(jnp.asarray, (logits, spans, tgt, mask)))
    want = jax_hungarian_match(*jargs, JaxLossConfig())
    got = hungarian_match(*map(torch.from_numpy, (logits, spans, tgt, mask)), LossConfig())
    cost = tm_cost(logits, spans, tgt, mask)
    np.testing.assert_allclose(cost, np.asarray(jax_matcher_cost(*jargs, JaxLossConfig())),
                               atol=1e-5, rtol=1e-6)
    best = _scipy_col_to_row(cost)
    total = lambda c, c2r: c[c2r[c2r < q], np.flatnonzero(c2r < q)].sum()
    got_pairs, got_valid = got.tgt_to_pred.numpy(), got.pair_valid.numpy()
    ours = lsap.solve_batch(torch.from_numpy(cost)).numpy()
    jax_optimal = 0
    for i in range(b):          # an invalid target's prediction index means nothing
        np.testing.assert_allclose(total(cost[i], ours[i]), total(cost[i], best[i]), atol=1e-4)
        np.testing.assert_array_equal(got_valid[i], (ours[i] < q) & mask[i])
        v = got_valid[i]
        np.testing.assert_array_equal(got_pairs[i][v], ours[i][v])
        j2r = np.asarray(jax_lsap.solve_batch(jnp.asarray(cost[i:i + 1], jnp.float32)))[0]
        if abs(total(cost[i], j2r) - total(cost[i], best[i])) <= 1e-4:
            np.testing.assert_array_equal(v, np.asarray(want.pair_valid[i]))
            np.testing.assert_array_equal(got_pairs[i][v], np.asarray(want.tgt_to_pred[i])[v])
            jax_optimal += 1
    assert jax_optimal >= b - 2


OUT_KEYS = ("memory", "pred_logits_layers", "pred_spans_layers", "proj_queries_layers")


@pytest.mark.kernel
@pytest.mark.usefixtures("scipy_jax_lsap")
@pytest.mark.parametrize("fused_decoder", [False, True])
def test_q3_forward_loss_and_step_match_jax(fused_decoder):
    cfg, jcfg = _configs()
    batch = example_batch(np.random.RandomState(0), cfg, 8)
    params = _jax_params(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxMaDe(jcfg)

    def loss_fn(p):
        out = jmodel.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                           jb["segment_mask"], v_duration=jb["v_duration"], deterministic=True)
        return jax_total_loss(out, jb["spans_target"], jcfg)[0], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert jout["pred_spans_layers"].shape[2] == Q

    model = load_jax_params(MaDe(cfg), params, cfg)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"], v_duration=tb["v_duration"],
                    fused_decoder=fused_decoder)
        loss, _ = total_loss(out, tb["spans_target"], cfg)
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    step = make_train_step(model, cfg, make_optimizer(model, cfg, 100), fused_decoder)
    log = step(tb)
    np.testing.assert_allclose(float(log["loss"]), float(jloss), rtol=1e-5)
    want = jax_tree_to_state_dict(jgrads, cfg)
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=1e-4, err_msg=name)
    assert fdl.fused_decoder_layer.launches == fdl.fused_decoder_layer_bwd.launches == 0


@pytest.mark.kernel
@pytest.mark.usefixtures("scipy_jax_lsap")
def test_q3_evaluate_matches_jax(tmp_path):
    """evaluate() at Q=3, plain and fused decoder, against JAX's on 44
    synthetic rows at batch 16: the moment of each row is its best query's."""
    cfg, jcfg = _configs()
    root = str(tmp_path / "data")
    synthetic.generate(root, n_rows=44, data_cfg=cfg.data, seed=3, family_size=2)
    data = synthetic.open_synthetic(root, cfg.data)
    params = _jax_params(jcfg, seed=1)
    want = jax_evaluate(JaxMaDe(jcfg), params, jax_synthetic.open_synthetic(root, jcfg.data),
                        jcfg, batch_size=16)
    model = load_jax_params(MaDe(cfg), params, cfg)
    for fused_decoder in (False, True):
        got = evaluate(model, data, cfg, batch_size=16, fused_decoder=fused_decoder)
        np.testing.assert_array_equal(got["ranks"], want["ranks"])
        assert got["retrieval"] == want["retrieval"]
        for key in ("localization", "composite"):
            for k, v in want[key].items():
                np.testing.assert_allclose(got[key][k], v, atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["pred_spans"] / cfg.data.max_m_duration,
                                   want["pred_spans"] / cfg.data.max_m_duration, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_q3_engine_matches_jax():
    """The serving engine at Q=3: top-k ids, retrieval scores, and each
    candidate's moment from its best-scoring query, plain path."""
    data = DataConfig(max_v_frames=8, stride=30.0, filter_sec=30.0, vit_dim=32, ast_dim=48)
    model_cfg = ModelConfig(dim_input=16, temporal_mlp_dim=32, detr_ffn_dim=32,
                            detr_enc_layers=1, detr_dec_layers=2, temporal_heads=4,
                            detr_heads=4, contrastive_dim=16, video_pe_len=16,
                            audio_pe_len=16, compute_dtype="float32",
                            fused_detr_encoder=False, fused_xpool_sim=False,
                            num_moment_queries=Q)
    jcfg = dataclasses.replace(JaxConfig(), data=data, model=model_cfg)
    cfg = Config.from_overrides({f"data.{k}": v for k, v in dataclasses.asdict(data).items()}
                                | {f"model.{k}": v
                                   for k, v in dataclasses.asdict(model_cfg).items()})
    f, s = data.max_v_frames, data.max_snippet_num
    rng = np.random.default_rng(0)
    jmodel = JaxMaDe(jcfg)
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, f, data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, data.ast_dim)), jnp.ones((1, s)))
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), init)
    seg_feats = rng.standard_normal((10, s, data.ast_dim), dtype=np.float32)
    seg_masks = (np.arange(s)[None] < rng.integers(1, s + 1, 10)[:, None]).astype(np.float32)
    frames = rng.standard_normal((3, f, data.vit_dim), dtype=np.float32)
    fmask = (np.arange(f)[None] < rng.integers(2, f + 1, 3)[:, None]).astype(np.float32)
    ids = [f"m{i}" for i in range(10)]
    jindex = jengine.build_music_index(jmodel, params, jcfg, ids, seg_feats, seg_masks,
                                       batch_size=5)
    want = jengine.RetrievalEngine(jmodel, params, jcfg, jindex, sim_block_size=4,
                                   use_fused_kernels=False).query(frames, fmask, top_k=3)
    model = load_jax_params(MaDe(cfg), params, cfg).eval()
    tindex = tengine.build_music_index(model, ids, seg_feats, seg_masks, batch_size=5)
    got = tengine.RetrievalEngine(model, cfg, tindex, sim_block_size=4).query(
        frames, fmask, top_k=3)
    for a, b in zip(got, want):
        assert a["music_ids"] == b["music_ids"]
        np.testing.assert_allclose(a["retrieval_scores"], b["retrieval_scores"], atol=1e-4)
        np.testing.assert_allclose(a["moment_scores"], b["moment_scores"], atol=1e-4)
        np.testing.assert_allclose(a["moments"], b["moments"], atol=1e-3)


def test_fused_decoder_refuses_training_with_dropout():
    """JAX's fused decoder layer has no dropout: a training call with
    detr_dropout > 0 raises rather than train another model; evaluation and
    detr_dropout = 0 run."""
    cfg, _ = _configs(**{"model.detr_dropout": 0.1})
    model = MaDe(cfg, torch.Generator().manual_seed(0))
    batch = to_tensors(example_batch(np.random.RandomState(0), cfg, 4), "cpu")
    step = make_train_step(model, cfg, make_optimizer(model, cfg, 100), fused_decoder=True)
    with pytest.raises(ValueError, match="detr_dropout"):
        step(batch)
    out = make_eval_step(model, cfg, fused_decoder=True)(batch)
    assert np.isfinite(float(out["loss"]))
    cfg0, _ = _configs()
    model0 = MaDe(cfg0, torch.Generator().manual_seed(0))
    log = make_train_step(model0, cfg0, make_optimizer(model0, cfg0, 100), True)(batch)
    assert np.isfinite(float(log["loss"]))
