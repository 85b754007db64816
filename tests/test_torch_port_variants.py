"""MaDe's variant matrix in the port against the JAX package, on the CPU at
tiny widths (D=32, FFN 64, 1 encoder and 2 decoder layers, batch 8): the
CA fusion (models/cross.py), both X-Pool sides, every vmr_loss, the
pre-norm DETR, the regression and moment heads, the other decoder
queries and the shared temporal stack.

Each case carries one JAX parameter tree across with `load_jax_params` and
feeds the same seeded numpy batch to both sides in float32, dropout off.
The tree is built from a seeded port model through JAX's own importer
(`import_uni_state_dict`), every weight moved off its init, so JAX compiles
no init per case; `tests/test_torch_port_copies.py` holds the key map
against JAX's init for these configurations.  JAX runs its plain layers
(its Pallas kernels are the same functions, held to them by the JAX
package's own tests; the paper branch's tests run them in interpret mode),
the port its kernel wrappers, which run their plain versions on CPU
tensors.  Compared: every output key of MaDe.forward (atol 1e-5, rtol
1e-5), the loss (rtol 1e-5) and every entry of the train step's log
(atol 1e-5, rtol 1e-4), every gradient (atol 1e-5, rtol 1e-4, as
tests/test_torch_port_train.py; a parameter the port's autograd leaves
without a gradient must have a zero one in JAX), the eval step's outputs
(spans as fractions of max_m_duration, atol 1e-5) and the corpus
similarity (atol 1e-5), or both sides' refusal of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.eval.evaluator import corpus_similarity as jax_corpus_similarity
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu.interop.torch_import import import_uni_state_dict
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.ops.spans import eval_iou_batch as jax_eval_iou_batch
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mgsv_tpu.train.step import decode_top_span as jax_decode_top_span
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.eval.evaluator import corpus_similarity
from mgsv_tpu_torch.interop.from_jax import (load_jax_params, load_reference_bin,
                                             save_reference_bin)
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models import made as made_mod
from mgsv_tpu_torch.models.cross import CrossTransformer
from mgsv_tpu_torch.models.layers import Dropout
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.serve import engine as tengine
from mgsv_tpu_torch.train.optimizer import FROZEN, make_optimizer, param_groups
from mgsv_tpu_torch.train.step import make_eval_step, make_train_step

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32",
        "model.ca_heads": 4, "model.ca_dim_head": 8, "model.ca_mlp_dim": 64,
        "model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0,
        "model.ca_dropout": 0.0}
# JAX's plain layers in place of its Pallas kernels (the same functions)
JAX_PLAIN = {"model.fused_detr_encoder": False, "model.fused_xpool_sim": False}
# the JAX step's XLA compile without the backend's costly passes
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BATCH = 8
HORIZON = 100
ATOL, RTOL = 1e-5, 1e-4
OUT_ATOL, OUT_RTOL = 1e-5, 1e-5

# (id, overrides, fused_decoder): the 12 reference switches of
# tests/test_made_parity.py's _VARIANTS, then the other branches
VARIANTS = [
    ("ca_fusion", {"model.mml_fusion": "CA"}, False),
    ("xa_video_single", {"model.vmr_fusion": "XA-video", "loss.vmr_loss": "single"}, False),
    ("xa_both_single", {"model.vmr_fusion": "XA-music-video", "loss.vmr_loss": "single"},
     False),
    ("vmr_dual", {"loss.vmr_loss": "dual"}, False),
    ("vmr_sim_fuse", {"loss.vmr_loss": "dual_single_sim_fuse"}, False),
    ("vmr_feature_fuse", {"loss.vmr_loss": "dual_single_feature_fuse"}, False),
    ("audio_short_cut", {"model.audio_short_cut": True}, False),
    ("moment_query_music", {"model.moment_query_type": "music"}, False),
    ("moment_query_xpool", {"model.moment_query_type": "xpool"}, False),
    ("predict_center", {"model.predict_center": True}, False),
    ("moment_head", {"model.moment_loss": True}, False),
    ("detr_pre_norm", {"model.detr_pre_norm": True}, False),
    ("regression", {"model.mml_localization": "regression"}, False),
    ("regression_center", {"model.mml_localization": "regression",
                           "model.predict_center": True}, False),
    ("no_xpool_dual", {"model.vmr_fusion": "NO", "loss.vmr_loss": "dual"}, False),
    ("xa_both_oneloss", {"model.vmr_fusion": "XA-music-video",
                         "loss.vmr_loss": "dual_single_oneloss"}, False),
    ("moment_query_zero", {"model.moment_query_type": "zero"}, False),
    ("moment_head_short_cut", {"model.moment_loss": True, "model.audio_short_cut": True},
     False),
    ("shared_temporal", {"model.transformer_is_share": True}, False),
    ("shared_fused_temporal", {"model.transformer_is_share": True,
                               "model.fused_temporal": True}, False),
    ("ca_fused_decoder", {"model.mml_fusion": "CA"}, True),
]


# modules that no loss reaches (where built), and where (every override
# must match)
NO_GRAD = {"video_guided_to_music_pooling_cross_transformer": {"loss.vmr_loss": "dual"},
           "detr_transformer.decoder.": {"model.mml_localization": "regression"},
           "moment_embed": {"model.moment_loss": True}}


def _configs(extra, jax_extra=JAX_PLAIN):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides({**overrides,
                                                                      **jax_extra})


def _jax_params(cfg, jcfg, seed=0):
    """A JAX parameter tree of the configuration: a seeded port model's
    weights, each moved by 0.05 N(0, 1) (so identity X-Pools, zero biases
    and unit norms carry signal), through JAX's importer."""
    model = MaDe(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    state = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in model.state_dict().items()}
    return import_uni_state_dict(state, jcfg)


def _jax_step(jcfg, params, batch):
    """JAX's loss, log, outputs, gradients and eval-step outputs: the
    bodies of its make_train_step (loss, train_iou, grad_norm) and
    make_eval_step, dropout off, in one jit."""
    model = JaxMaDe(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = model.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                          jb["segment_mask"], v_duration=jb["v_duration"], deterministic=True)
        loss, log = jax_total_loss(out, jb["spans_target"], jcfg)
        return loss, (out, log)

    def run(p):
        (loss, (out, log)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        spans_sec, score = jax_decode_top_span(out, jcfg)
        iou = jax_eval_iou_batch(jb["gt_moment"][:, 0, :], jb["m_duration"], spans_sec,
                                 jcfg.data.max_m_duration)
        log = dict(log, train_iou=iou, grad_norm=optax.global_norm(grads))
        ev = {"video_emb": out["video_emb"], "music_emb": out["music_emb"],
              "seg_tokens": out["seg_tokens"], "segment_mask": out["segment_mask"],
              "pred_spans_sec": spans_sec, "pred_score": score, "iou": iou, "loss": loss,
              "retrieval_loss": log["retrieval_loss"],
              "localization_loss": log["localization_loss"]}
        return loss, out, log, grads, ev

    # XLA's cheaper CPU backend: the compile is most of a case's time
    return jax.device_get(jax.jit(run).lower(params).compile(FAST_COMPILE)(params))


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _refusal(fn):
    try:
        return fn(), None
    except (KeyError, ValueError) as err:
        return None, type(err)


def _assert_update(model, before, after, grads, cfg, lr):
    """The weights after one Adam update against optax's from JAX's
    gradients: lr * sign(g) where |g| is above the gradient tolerance, so
    an element whose gradient lies within it of zero may differ by 2 lr;
    the frozen group and the parameters without a gradient do not move."""
    want, start = jax_tree_to_state_dict(after, cfg), jax_tree_to_state_dict(before, cfg)
    g = jax_tree_to_state_dict(grads, cfg)
    frozen = {n for n, _ in param_groups(model)[FROZEN]}
    untouched = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if name in frozen or p.grad is None:
            np.testing.assert_array_equal(got, start[name], err_msg=name)
            np.testing.assert_array_equal(want[name], start[name], err_msg=name)
            untouched += name not in frozen
            continue
        near_zero = np.abs(g[name]) <= ATOL + RTOL * np.abs(g[name])
        tol = np.where(near_zero, 2 * lr, 0.0) + 1e-6
        assert (np.abs(got - want[name]) <= tol).all(), name
    return untouched


@pytest.mark.parametrize("extra,fused_decoder", [v[1:] for v in VARIANTS],
                         ids=[v[0] for v in VARIANTS])
def test_variant_matches_jax(extra, fused_decoder):
    cfg, jcfg = _configs({**extra, "train.scheduler": "constant"})
    batch = example_batch(np.random.RandomState(0), cfg, BATCH)
    params = _jax_params(cfg, jcfg)
    jloss, jout, jlog, jgrads, jeval = _jax_step(jcfg, params, batch)

    model = load_jax_params(MaDe(cfg), params, cfg)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"], v_duration=tb["v_duration"],
                    fused_decoder=fused_decoder)
    # XA-music with a sim-only loss: the port's X-Pool kernel gives the
    # [V, M] similarity where JAX's plain path (fused_xpool_sim off) gives
    # the pooled tensor; its similarity is compared through the losses
    if "single_sim" in out:
        assert model.use_fused_sim and "music_pooled" in jout
        jout = dict(jout)
        del jout["music_pooled"]
        del out["single_sim"]
    assert out.keys() == jout.keys()
    for k in jout:
        _close(out[k], jout[k], k, OUT_ATOL, OUT_RTOL)

    ev = make_eval_step(model, cfg, fused_decoder)(tb)
    assert ev.keys() == jeval.keys()
    for k, v in jeval.items():
        scale = cfg.data.max_m_duration if k == "pred_spans_sec" else 1.0
        _close(ev[k] / scale, v / scale, f"eval {k}")

    # the corpus similarity of the eval step's outputs (before the update
    # moves the weights), or both sides' refusal
    args = [ev[k] for k in ("video_emb", "music_emb", "seg_tokens", "segment_mask")]
    got, got_err = _refusal(lambda: corpus_similarity(model, *args, cfg, block_size=4))
    want_sim, want_err = _refusal(lambda: jax_corpus_similarity(
        params, *(a.numpy() for a in args), jcfg, block_size=4))
    if want_err is not None:
        assert got_err is ValueError, f"JAX raised {want_err}, the port {got_err}"
    else:
        assert got_err is None
        _close(got, want_sim, "corpus similarity")

    step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON), fused_decoder)
    log = step(tb)
    np.testing.assert_allclose(float(log["loss"]), float(jloss), rtol=1e-5)
    assert log.keys() == jlog.keys()
    for k, v in jlog.items():
        _close(log[k], v, f"log {k}")
    want = jax_tree_to_state_dict(jgrads, cfg)
    assert {n for n, _ in model.named_parameters()} == want.keys()
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        _close(got, want[name], f"grad {name}")
    assert all(fn.launches == 0 for fn in (fel.fused_encoder_layer, xps.xpool_sim_fwd,
                                           ftl.fused_temporal_layer, fdl.fused_decoder_layer))

    # the step's GroupedAdam update (constant lr) against optax's from JAX's
    # gradients; where the loss reaches no parameter of a module (the
    # X-Pool under "dual", the decoder and its queries under regression,
    # the moment head, which no loss reads) the port has None, JAX zeros
    tx = jax_make_optimizer(jcfg, HORIZON)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    after = jax.device_get(optax.apply_updates(params, updates))
    no_grad = {n for n, p in model.named_parameters() if p.grad is None}
    assert _assert_update(model, params, after, jgrads, cfg, cfg.train.matching_lr) == len(
        no_grad - {n for n, _ in param_groups(model)[FROZEN]})
    names = [n for n, _ in model.named_parameters()]
    for prefix, where in NO_GRAD.items():
        if all(extra.get(a) == b for a, b in where.items()):
            owned = {n for n in names if n.startswith(prefix)}
            assert owned <= no_grad, prefix



def test_routes_follow_jax():
    """The port's use_fused_sim is JAX's (made.py:180-184), pre-norm keeps
    the DETR off the encoder-layer kernel in the model and in the engine
    (detr.py:321, engine.py:126) and refuses fused_decoder, and the shared
    stack is one module whose depth overrides are refused."""
    fused = lambda **kw: MaDe(_configs(kw)[0]).use_fused_sim
    assert fused()
    assert fused(**{"loss.vmr_loss": "single"}) and fused(**{"loss.vmr_loss":
                                                             "dual_single_sim_fuse"})
    assert not fused(**{"loss.vmr_loss": "dual"})
    assert not fused(**{"loss.vmr_loss": "dual_single_feature_fuse"})
    assert not fused(**{"model.vmr_fusion": "XA-music-video", "loss.vmr_loss": "single"})
    assert not fused(**{"model.moment_query_type": "xpool"})
    assert not fused(**{"model.fused_xpool_sim": False})

    cfg, _ = _configs({"model.detr_pre_norm": True})
    model = MaDe(cfg, torch.Generator().manual_seed(0))
    tb = to_tensors(example_batch(np.random.RandomState(1), cfg, 4), "cpu")
    calls = []
    real = fel.fused_encoder_layer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fel, "fused_encoder_layer", lambda *a, **k: calls.append(1) or real(*a, **k))
        with torch.no_grad():
            model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"], tb["segment_mask"])
            post = MaDe(_configs({})[0])
            post(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"], tb["segment_mask"])
    assert len(calls) == cfg.model.detr_enc_layers          # the post-norm model's only
    with pytest.raises(ValueError, match="pre_norm"):
        model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"], tb["segment_mask"],
              fused_decoder=True)
    index = tengine.build_music_index(model, ["a", "b"], np.zeros((2, 12, 96), np.float32),
                                      np.ones((2, 12), np.float32))
    assert not tengine.RetrievalEngine(model, cfg, index, use_fused_kernels=True
                                       ).use_fused_kernels
    assert tengine.RetrievalEngine(post, _configs({})[0], index, use_fused_kernels=True
                                   ).use_fused_kernels

    shared = MaDe(_configs({"model.transformer_is_share": True})[0])
    assert shared.temporal("video") is shared.temporal("music") is shared.share_transformer
    assert not any(n.startswith(("video_transformer", "audio_transformer"))
                   for n, _ in shared.named_parameters())
    with pytest.raises(ValueError, match="one temporal stack"):
        MaDe(_configs({"model.transformer_is_share": True,
                       "model.video_temporal_depth": 2})[0])


def test_ca_runs_float32_under_bf16():
    """Under a bf16 compute dtype the CA fusion (and the music-guided
    X-Pool) run in float32, as JAX's modules, which take no dtype: the CA
    module's output is float32 and equals the module run on its own inputs
    outside autocast, and the bf16 model's forward stays within the bf16
    tolerance of tests/test_torch_port_bf16_detr.py (5e-2) of JAX's bf16
    forward."""
    extra = {"model.mml_fusion": "CA", "model.compute_dtype": "bfloat16",
             "model.vmr_fusion": "XA-music-video"}
    cfg, jcfg = _configs(extra)
    batch = example_batch(np.random.RandomState(3), cfg, BATCH)
    params = _jax_params(cfg, jcfg, seed=2)
    model = load_jax_params(MaDe(cfg), params, cfg)
    seen = {}
    for name in ("video_music_fusion_cross_transformer",
                 "music_guided_to_video_pooling_cross_transformer"):
        getattr(model, name).register_forward_hook(
            lambda mod, args, kwargs, res, name=name: seen.update({name: (mod, args, kwargs,
                                                                          res)}),
            with_kwargs=True)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"])
        for name, (mod, args, kwargs, res) in seen.items():
            res = res[0] if isinstance(res, tuple) else res
            assert res.dtype == torch.float32, name
            assert all(a.dtype == torch.float32 for a in args if a is not None), name
            with torch.autocast("cpu", enabled=False):
                again = mod(*args, **kwargs)
            again = again[0] if isinstance(again, tuple) else again
            torch.testing.assert_close(res, again, atol=0, rtol=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jax.jit(lambda p: JaxMaDe(jcfg).apply(
        p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"], jb["segment_mask"],
        deterministic=True))(params)
    for k in ("memory", "video_pooled", "pred_spans_layers", "proj_queries_layers"):
        _close(out[k].float(), jnp.asarray(jout[k], jnp.float32), k, atol=5e-2, rtol=0)


def test_ca_dropout_keeps_its_rate():
    """ca_dropout on to_out and on both FeedForward outputs: each site
    keeps 1 - rate of its elements, scaled by 1 / (1 - rate), drawn from
    the caller's generator (the same generator state, the same masks);
    without a generator nothing drops."""
    rate = 0.8
    ca = CrossTransformer(32, depth=1, heads=4, dim_head=8, mlp_dim=64, out_dim=32,
                          dropout=rate)
    ca.reset_parameters(torch.Generator().manual_seed(0))
    sites = [m for m in ca.modules() if isinstance(m, Dropout)]
    assert len(sites) == 3 and all(m.rate == rate for m in sites)
    seen = []
    for m in sites:
        m.register_forward_hook(lambda mod, args, res: seen.append((args[0], res)))
    rng = np.random.default_rng(0)
    q, c = (torch.from_numpy(rng.standard_normal((16, n, 32), dtype=np.float32))
            for n in (40, 30))
    runs = []
    for gen in (torch.Generator().manual_seed(5), torch.Generator().manual_seed(5), None):
        seen.clear()
        with torch.no_grad():
            runs.append(ca(q, c, generator=gen)[0])
        if gen is None:
            assert all(torch.equal(x, y) for x, y in seen)
            continue
        for x, y in seen:
            kept = y != 0
            frac = kept.float().mean().item()
            n = kept.numel()
            assert abs(frac - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n), frac
            torch.testing.assert_close(y[kept], x[kept] / (1 - rate))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_xa_video_refused_where_jax_fails():
    """vmr_fusion XA-video builds no video-guided music X-Pool: JAX's
    corpus similarity (any loss but "dual") and engine read its absent
    parameters and fail with KeyError; the port raises ValueError naming
    the cause.  "dual" evaluates on both sides."""
    cfg, jcfg = _configs({"model.vmr_fusion": "XA-video", "loss.vmr_loss": "single"})
    params = _jax_params(cfg, jcfg)
    model = load_jax_params(MaDe(cfg), params, cfg)
    rng = np.random.default_rng(0)
    n, s, d = 6, cfg.data.max_snippet_num, cfg.model.dim_input
    embs = [rng.standard_normal((n, d), dtype=np.float32) for _ in range(2)]
    toks = rng.standard_normal((n, s, d), dtype=np.float32)
    masks = np.ones((n, s), np.float32)
    with pytest.raises(KeyError):
        jax_corpus_similarity(params, *embs, toks, masks, jcfg)
    with pytest.raises(ValueError, match="XA-video"):
        corpus_similarity(model, *map(torch.from_numpy, (*embs, toks, masks)), cfg)
    dual, jdual = _configs({"model.vmr_fusion": "XA-video", "loss.vmr_loss": "dual"})
    _close(corpus_similarity(model, *map(torch.from_numpy, (*embs, toks, masks)), dual),
           jax_corpus_similarity(params, *embs, toks, masks, jdual), "dual similarity")

    feats = rng.standard_normal((3, s, cfg.data.ast_dim), dtype=np.float32)
    fmask = np.ones((3, s), np.float32)
    jindex = jengine.build_music_index(JaxMaDe(jcfg), params, jcfg, ["a", "b", "c"], feats,
                                       fmask)
    frames = rng.standard_normal((1, cfg.data.max_v_frames, cfg.data.vit_dim),
                                 dtype=np.float32)
    with pytest.raises(KeyError):
        jengine.RetrievalEngine(JaxMaDe(jcfg), params, jcfg, jindex).query(
            frames, np.ones(frames.shape[:2], np.float32), top_k=2)
    index = tengine.build_music_index(model, ["a", "b", "c"], feats, fmask)
    with pytest.raises(ValueError, match="vmr_fusion='XA-video'"):
        tengine.RetrievalEngine(model, cfg, index)


@pytest.mark.parametrize("extra", [{"model.agg_module": "mlp"},
                                   {"model.with_cls_token": True}])
def test_unported_branches_raise(extra):
    """The EmbeddingNet aggregator and the cls token, once refused, now
    build (tests/test_torch_port_aggregators.py holds them to JAX); what
    raises for them is a reference-format checkpoint, read or written,
    exactly where JAX's torch export and import raise."""
    cfg, jcfg = _configs(extra)
    model = MaDe(cfg)
    added = {"model.agg_module": "video_embedding_net", "model.with_cls_token":
             "video_cls_token"}[next(iter(extra))]
    assert hasattr(model, added) and not hasattr(made_mod, "_unsupported")
    with pytest.raises(NotImplementedError, match="agg_module"):
        export_uni_state_dict({}, jcfg)
    with pytest.raises(NotImplementedError, match="agg_module"):
        import_uni_state_dict({}, jcfg)
    with pytest.raises(NotImplementedError, match="no reference-format checkpoint"):
        save_reference_bin(model, cfg, "never-written.bin")
    with pytest.raises(NotImplementedError, match="no reference-format checkpoint"):
        load_reference_bin("never-read.bin", cfg)
