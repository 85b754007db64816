"""The EmbeddingNet aggregator (agg_module="mlp"), agg_module "None" and the
per-tower cls token in the port, against the JAX package on the CPU at the
tiny widths of tests/test_torch_port_variants.py (D=32, FFN 64, 1 encoder
and 2 decoder layers, batch 8), float32 with TF32 off, dropout off.

Weights: a JAX init (its XLA compile on the cheaper CPU backend), every
parameter moved by 0.05 N(0, 1) and every BatchNorm buffer off its init, so
that no weight or buffer passes by symmetry; they cross with
`load_jax_params`, `params` and `batch_stats` both, strictly.  Inputs:
numpy seeds.  JAX runs its plain layers, and with fused_temporal its
FusedTemporalTransformer (its Pallas kernels in interpret mode, as its own
CPU tests run it); the port runs its kernel wrappers, which take their plain
versions on CPU tensors.

Tolerances, those of tests/test_torch_port_variants.py: forward outputs
atol 1e-5 and rtol 1e-5; losses rtol 1e-5; the step's log, gradients,
running buffers and the eval step's outputs atol 1e-5 and rtol 1e-4 (spans
as fractions of max_m_duration); bf16 forwards 5e-2 absolute
(tests/test_torch_port_bf16_detr.py).  After Adam updates a parameter may
differ from JAX's by 2 lr per update where the mean gradient of that update
lies within the gradient tolerance of zero (either framework may take its
sign; test_torch_port_variants.py::_assert_update), elsewhere by 1e-6 plus
1e-3 of its move; engines: the same ids, scores 1e-4, moments 1e-3 s
(tests/test_torch_port_serve.py).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.errors import ScopeCollectionNotFound

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.eval.evaluator import corpus_similarity as jax_corpus_similarity
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu.interop.torch_import import import_uni_state_dict
from mgsv_tpu.models.embedding_net import EmbeddingNet as JaxEmbeddingNet
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.ops.spans import eval_iou_batch as jax_eval_iou_batch
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mgsv_tpu.train.step import TrainState
from mgsv_tpu.train.step import decode_top_span as jax_decode_top_span
from mgsv_tpu.train.step import make_eval_step as jax_make_eval_step
from mgsv_tpu.train.step import make_train_step as jax_make_train_step
from mgsv_tpu_torch.cli import evaluate as evaluate_cli
from mgsv_tpu_torch.cli import index as index_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.checkpoint import CheckpointManager
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore
from mgsv_tpu_torch.eval.evaluator import corpus_similarity, evaluate
from mgsv_tpu_torch.interop.from_jax import (check_reference_format, embedding_net_state,
                                             jax_variables_to_state_dict, load_jax_params,
                                             load_reference_bin, save_reference_bin)
from mgsv_tpu_torch.models.embedding_net import EmbeddingNet
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve import engine as tengine
from mgsv_tpu_torch.train.loop import Preempted, Trainer
from mgsv_tpu_torch.train.optimizer import FROZEN, TEMPORAL, make_optimizer, param_groups
from mgsv_tpu_torch.train.step import make_eval_step, make_train_step

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32",
        "model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0}
# JAX's plain layers in place of its Pallas kernels (the same functions)
JAX_PLAIN = {"model.fused_detr_encoder": False, "model.fused_xpool_sim": False}
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BATCH = 8
HORIZON = 100
ATOL, RTOL = 1e-5, 1e-4
OUT_ATOL, OUT_RTOL = 1e-5, 1e-5
BF16_ATOL = 5e-2
SCORE_ATOL, SPAN_ATOL = 1e-4, 1e-3

MLP = {"model.agg_module": "mlp"}
CLS = {"model.with_cls_token": True}
CASES = {"mlp": MLP, "cls": CLS, "mlp_cls": {**MLP, **CLS},
         "none": {"model.agg_module": "None"},
         "cls_shared": {**CLS, "model.transformer_is_share": True},
         "cls_fused_temporal": {**CLS, "model.fused_temporal": True}}


def _configs(extra):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides({**overrides,
                                                                      **JAX_PLAIN})


@functools.lru_cache(maxsize=None)
def _cached_variables(items, seed):
    _, jcfg = _configs(dict(items))
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    key = jax.random.PRNGKey(seed)
    init = jax.jit(lambda k: JaxMaDe(jcfg).init(
        k, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))
    tree = jax.device_get(init.lower(key).compile(FAST_COMPILE)(key))
    return _perturbed(tree, seed)


def _jax_variables(extra, seed=0):
    """A JAX MaDe variable tree of the configuration, moved off its init."""
    return _cached_variables(tuple(sorted(extra.items())), seed)


def _perturbed(tree, seed):
    """params + 0.05 N(0, 1); batch_stats means + 0.1 N(0, 1), variances
    times exp(0.2 N(0, 1))."""
    rng = np.random.default_rng(seed)
    noise = lambda x, s: (s * rng.standard_normal(np.shape(x))).astype(np.float32)
    out = {"params": jax.tree.map(lambda x: x + noise(x, 0.05), tree["params"])}
    if "batch_stats" in tree:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: x * np.exp(noise(x, 0.2)) if path[-1].key.endswith("_var")
            else x + noise(x, 0.1), tree["batch_stats"])
    return out


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


def _buffers(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _jax_step(jcfg, variables, batch):
    """JAX's training-mode loss, log (train_iou, grad_norm), gradients and
    updated batch_stats (the body of its make_train_step, dropout rates 0),
    and its deterministic forward and eval-step outputs, in one jit."""
    model = JaxMaDe(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jb["frame_feats"], jb["frame_mask"], jb["segment_feats"], jb["segment_mask"])
    has_bn = "batch_stats" in variables

    def loss_fn(params, variables):
        kw = dict(v_duration=jb["v_duration"], deterministic=False,
                  rngs={"dropout": jax.random.PRNGKey(0)})
        v = {**variables, "params": params}
        if has_bn:
            out, updated = model.apply(v, *args, mutable=["batch_stats"], **kw)
            stats = updated["batch_stats"]
        else:
            out, stats = model.apply(v, *args, **kw), None
        loss, log = jax_total_loss(out, jb["spans_target"], jcfg)
        return loss, (out, log, stats)

    def run(variables):
        (loss, (out, log, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"], variables)
        spans_sec, _ = jax_decode_top_span(out, jcfg)
        iou = jax_eval_iou_batch(jb["gt_moment"][:, 0, :], jb["m_duration"], spans_sec,
                                 jcfg.data.max_m_duration)
        log = dict(log, train_iou=iou, grad_norm=optax.global_norm(grads))
        eout = model.apply(variables, *args, v_duration=jb["v_duration"], deterministic=True)
        eloss, elog = jax_total_loss(eout, jb["spans_target"], jcfg)
        espans, escore = jax_decode_top_span(eout, jcfg)
        ev = {"video_emb": eout["video_emb"], "music_emb": eout["music_emb"],
              "seg_tokens": eout["seg_tokens"], "segment_mask": eout["segment_mask"],
              "pred_spans_sec": espans, "pred_score": escore,
              "iou": jax_eval_iou_batch(jb["gt_moment"][:, 0, :], jb["m_duration"], espans,
                                        jcfg.data.max_m_duration),
              "loss": eloss, "retrieval_loss": elog["retrieval_loss"],
              "localization_loss": elog["localization_loss"]}
        return loss, log, grads, stats, eout, ev

    return jax.device_get(jax.jit(run).lower(variables).compile(FAST_COMPILE)(variables))


# -------------------------------------------------------------- EmbeddingNet


@pytest.mark.parametrize("calls", [1, 3])
def test_embedding_net_matches_jax(calls):
    """The port's EmbeddingNet against JAX's, weights and buffers carried by
    from_jax's key map: each training call's output and every parameter's
    gradient, the running buffers after `calls` training calls (BN1 at
    momentum 0.1, BN2 at 0.99, unbiased variances), then an evaluation call
    that normalizes with those buffers and leaves them alone."""
    d, length, b, hidden = 32, 13, 8, 64
    jnet = JaxEmbeddingNet(d, hidden=hidden)
    rng = np.random.default_rng(calls)
    variables = _perturbed(jax.device_get(jnet.init(jax.random.PRNGKey(calls),
                                                    jnp.zeros((b, length, d)))), calls)
    net = EmbeddingNet(d, length, hidden=hidden)
    net.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in embedding_net_state(
        variables["params"], variables["batch_stats"]).items()}, strict=True)
    params = variables["params"]
    stats = variables["batch_stats"]
    for call in range(calls):
        x = rng.standard_normal((b, length, d), dtype=np.float32)
        g = rng.standard_normal((b, length, d), dtype=np.float32)

        def fwd(p, stats=stats, x=x):
            return jnet.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                              deterministic=False, mutable=["batch_stats"])

        want, vjp, mutated = jax.vjp(fwd, params, has_aux=True)
        (jgrads,) = vjp(jnp.asarray(g))
        stats = mutated["batch_stats"]
        net.zero_grad()
        out = net(torch.from_numpy(x), training=True)
        out.backward(torch.from_numpy(g))
        _close(out, want, f"call {call} output", OUT_ATOL, OUT_RTOL)
        want_grads = embedding_net_state(jax.device_get(jgrads))
        assert {n for n, _ in net.named_parameters()} == want_grads.keys()
        for name, p in net.named_parameters():
            _close(p.grad, want_grads[name], f"call {call} grad {name}")
    want_bufs = embedding_net_state(params, jax.device_get(stats))
    got_bufs = _buffers(net)
    assert len(got_bufs) == 4
    for name, buf in got_bufs.items():
        _close(buf, want_bufs[name], f"{name} after {calls} calls")
    x = rng.standard_normal((b, length, d), dtype=np.float32)
    want = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                      deterministic=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
        batch_normed = net(torch.from_numpy(x), training=True)
    # the training call above moved the buffers: the evaluation call before it did not
    for name, buf in got_bufs.items():
        assert not torch.equal(buf, _buffers(net)[name]), name
    _close(got, want, "evaluation output", OUT_ATOL, OUT_RTOL)
    assert np.abs(batch_normed.numpy() - np.asarray(want)).max() > 100 * OUT_ATOL
    with pytest.raises(ValueError, match="sequences of 13"):
        net(torch.zeros(2, 12, d))


# ------------------------------------------------------------------- MaDe


@pytest.mark.parametrize("case", list(CASES))
def test_made_matches_jax(case):
    """One configuration through MaDe: every output of the deterministic
    forward, the eval step, the corpus similarity, then one training step's
    loss, log and every gradient, and the running buffers it leaves, each
    against JAX.  The cls token's tokens and mask leave without the cls row;
    the EmbeddingNet, the cls tokens and every parameter's group are
    TEMPORAL."""
    extra = CASES[case]
    cfg, jcfg = _configs({**extra, "train.scheduler": "constant"})
    batch = example_batch(np.random.RandomState(0), cfg, BATCH)
    variables = _jax_variables(extra)
    jloss, jlog, jgrads, jstats, jout, jeval = _jax_step(jcfg, variables, batch)

    model = load_jax_params(MaDe(cfg), variables, cfg)
    groups = {n: g for g, named in param_groups(model).items() for n, _ in named}
    for name, group in groups.items():
        if name.startswith(("video_cls", "audio_cls", "video_emb", "audio_emb")):
            assert group == TEMPORAL, name
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"], v_duration=tb["v_duration"])
    # the port's X-Pool kernel gives the [V, M] similarity where JAX's plain
    # path gives the pooled tensor; the losses compare the similarity
    assert model.use_fused_sim and "music_pooled" in jout
    jout = {k: v for k, v in jout.items() if k != "music_pooled"}
    del out["single_sim"]
    assert out.keys() == jout.keys()
    for k in jout:
        _close(out[k], jout[k], k, OUT_ATOL, OUT_RTOL)
    assert out["seg_tokens"].shape[1] == cfg.data.max_snippet_num
    assert out["frame_mask"].shape[1] == cfg.data.max_v_frames

    ev = make_eval_step(model, cfg)(tb)
    assert ev.keys() == jeval.keys()
    for k, v in jeval.items():
        scale = cfg.data.max_m_duration if k == "pred_spans_sec" else 1.0
        _close(ev[k] / scale, v / scale, f"eval {k}")
    args = [ev[k] for k in ("video_emb", "music_emb", "seg_tokens", "segment_mask")]
    _close(corpus_similarity(model, *args, cfg, block_size=4),
           jax_corpus_similarity(variables, *(a.numpy() for a in args), jcfg, block_size=4),
           "corpus similarity")

    before = _buffers(model)
    log = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON))(tb)
    np.testing.assert_allclose(float(log["loss"]), float(jloss), rtol=OUT_RTOL)
    assert log.keys() == jlog.keys()
    for k, v in jlog.items():
        _close(log[k], v, f"log {k}")
    want = jax_variables_to_state_dict(jgrads, cfg)
    assert {n for n, _ in model.named_parameters()} == want.keys()
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        _close(got, want[name], f"grad {name}")
    after = _buffers(model)
    assert len(after) == (8 if "mlp" in case else 0)
    if after:
        want = jax_variables_to_state_dict({**variables, "batch_stats": jstats}, cfg)
        for name, buf in after.items():
            assert not torch.equal(buf, before[name]), name
            _close(buf, want[name], f"{name} after the step")


def test_mlp_bf16_keeps_the_embedding_net_float32():
    """Under a bf16 compute dtype the EmbeddingNets compute in float32, as
    JAX's, whose Dense layers take no dtype: each one's output is float32
    and equals the module run on its own input outside autocast, in the
    forward and in a training step; the model's forward stays within the
    bf16 tolerance of JAX's bf16 forward."""
    extra = {**MLP, "model.compute_dtype": "bfloat16"}
    cfg, jcfg = _configs(extra)
    variables = _jax_variables(extra)
    model = load_jax_params(MaDe(cfg), variables, cfg)
    seen = []
    for which in ("video", "audio"):
        getattr(model, f"{which}_embedding_net").register_forward_hook(
            lambda mod, args, kwargs, res: seen.append((mod, args, kwargs, res)),
            with_kwargs=True)
    batch = example_batch(np.random.RandomState(3), cfg, BATCH)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jax.jit(lambda v: JaxMaDe(jcfg).apply(
        v, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"], jb["segment_mask"],
        deterministic=True))(variables)
    for k in ("frame_tokens", "seg_tokens", "video_emb", "memory", "pred_spans_layers"):
        _close(out[k].float(), jnp.asarray(jout[k], jnp.float32), k, atol=BF16_ATOL, rtol=0)
    assert len(seen) == 2                       # one call a tower
    for mod, args, kwargs, res in seen:
        assert res.dtype == args[0].dtype == torch.float32 and not kwargs["training"]
        with torch.no_grad(), torch.autocast("cpu", enabled=False):
            torch.testing.assert_close(res, mod.forward(*args, **kwargs), atol=0, rtol=0)
    make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON))(tb)
    assert len(seen) == 4 and all(kw["training"] and res.dtype == torch.float32
                                  for _, _, kw, res in seen[2:])


# ------------------------------------------------------------------ updates


def _assert_params(model, jparams, start, mean_grads, cfg, lr):
    """Parameters after Adam updates against JAX's (see the module's
    docstring): 2 lr per update where that update's mean gradient lies
    within the gradient tolerance of zero, else 1e-6 + 1e-3 of JAX's move."""
    want = jax_variables_to_state_dict(jparams, cfg)
    frozen = {n for n, _ in param_groups(model)[FROZEN]}
    moved = 0
    for name, p in model.named_parameters():
        got, w, s = p.detach().numpy(), want[name], start[name].numpy()
        if name in frozen:
            np.testing.assert_array_equal(got, s, err_msg=name)
            np.testing.assert_array_equal(w, s, err_msg=name)
            continue
        near = sum((np.abs(g[name]) <= 2 * ATOL + RTOL * np.abs(g[name])).astype(np.float32)
                   for g in mean_grads)
        tol = 1e-6 + 1e-3 * np.abs(w - s) + 2 * lr * near
        err = np.abs(got - w)
        assert (err <= tol).all(), f"{name}: max error {err.max()}"
        moved += int((np.abs(w - s) > lr / 2).sum())
    assert moved > 0


@pytest.mark.parametrize("accum,micro_steps", [(1, 3), (2, 4)])
def test_steps_match_jax_train_state(accum, micro_steps):
    """micro_steps training steps of an EmbeddingNet model through JAX's
    make_train_step (its TrainState over params and batch_stats, optax's
    MultiSteps at accum 2) and the port's, a new seeded batch each: each
    step's loss and gradient norm, the optimizer's micro-step against
    state.step, then the parameters (the updates of the mean gradients) and
    the running buffers, which move once per micro-batch, as JAX's do."""
    cfg, jcfg = _configs({**MLP, "train.scheduler": "constant",
                          "train.gradient_accumulation_steps": accum})
    variables = _jax_variables(MLP)
    jmodel = JaxMaDe(jcfg)
    tx = jax_make_optimizer(jcfg, HORIZON)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables, tx=tx)
    jstep = jax_make_train_step(jmodel, jcfg)
    key = jax.random.PRNGKey(1)

    model = load_jax_params(MaDe(cfg), variables, cfg)
    opt = make_optimizer(model, cfg, HORIZON)
    step = make_train_step(model, cfg, opt)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads, mean_grads = [], []
    for micro in range(micro_steps):
        batch = example_batch(np.random.RandomState(10 + micro), cfg, BATCH)
        state, jlog = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        log = step(to_tensors(batch, "cpu"))
        np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]), rtol=OUT_RTOL,
                                   err_msg=f"micro-step {micro}")
        np.testing.assert_allclose(float(log["grad_norm"]), float(jlog["grad_norm"]),
                                   rtol=RTOL, err_msg=f"micro-step {micro}")
        assert opt.micro_step == int(state.step) == micro + 1
        grads.append({n: p.grad.numpy().copy() if p.grad is not None
                      else np.zeros(tuple(p.shape), np.float32)
                      for n, p in model.named_parameters()})
        if len(grads) == accum:
            mean_grads.append({n: sum(g[n] for g in grads) / accum for n in grads[0]})
            grads = []
    assert opt.count == micro_steps // accum
    jstate = jax.device_get(state.params)
    _assert_params(model, jstate, start, mean_grads, cfg, cfg.train.matching_lr)
    want = jax_variables_to_state_dict(jstate, cfg)
    for name, buf in _buffers(model).items():
        _close(buf, want[name], f"{name} after {micro_steps} micro-steps")


def test_evaluation_uses_the_running_buffers():
    """JAX's make_eval_step against the port's on the weights and buffers of
    JAX's state after two training steps (an mlp + cls model), and the
    corpus similarity of their outputs; the evaluation leaves the buffers
    as they were and differs from a batch-statistics forward."""
    extra = {**MLP, **CLS}
    cfg, jcfg = _configs(extra)
    variables = _jax_variables(extra, seed=1)
    jmodel = JaxMaDe(jcfg)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables,
                              tx=jax_make_optimizer(jcfg, HORIZON))
    jstep = jax_make_train_step(jmodel, jcfg)
    for i in range(2):
        batch = example_batch(np.random.RandomState(20 + i), cfg, BATCH)
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(2))
    trained = jax.device_get(state.params)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), trained["batch_stats"],
                         variables["batch_stats"])
    assert min(jax.tree.leaves(moved)) > 0
    batch = example_batch(np.random.RandomState(30), cfg, BATCH)
    jeval = jax.device_get(jax_make_eval_step(jmodel, jcfg)(
        trained, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = load_jax_params(MaDe(cfg), trained, cfg)
    before = _buffers(model)
    tb = to_tensors(batch, "cpu")
    ev = make_eval_step(model, cfg)(tb)
    assert ev.keys() == jeval.keys()
    for k, v in jeval.items():
        scale = cfg.data.max_m_duration if k == "pred_spans_sec" else 1.0
        _close(ev[k] / scale, v / scale, f"eval {k}")
    for name, buf in _buffers(model).items():
        assert torch.equal(buf, before[name]), name
    args = [ev[k] for k in ("video_emb", "music_emb", "seg_tokens", "segment_mask")]
    _close(corpus_similarity(model, *args, cfg, block_size=4),
           jax_corpus_similarity(trained, *(a.numpy() for a in args), jcfg, block_size=4),
           "corpus similarity")
    with torch.no_grad():                      # a training call: batch statistics
        emb = model.video_tower(tb["frame_feats"], tb["frame_mask"],
                                generator=torch.Generator().manual_seed(0))[1]
    assert np.abs(emb.numpy() - jeval["video_emb"]).max() > 1e-3


# -------------------------------------------------------- trainer and CLIs


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    cfg = Config.from_overrides(TINY)
    root = str(tmp_path_factory.mktemp("data"))
    synthetic.generate(root, n_rows=48, n_unique_music=24, data_cfg=cfg.data, seed=0)
    return root


def _run_cfg(tmp_path, name, extra, **train):
    cfg = Config.from_overrides({**TINY, **extra, "train.batch_size_train": 16,
                                 "train.batch_size_val": 16, "model.temporal_dropout": 0.1})
    return cfg.replace(train=dataclasses.replace(cfg.train, output_dir=str(tmp_path / name),
                                                 **train))


def _args(cfg_overrides):
    return [a for k, v in cfg_overrides.items() for a in (f"--{k}", json.dumps(v))]


def test_trainer_resume_and_cli_evaluate(tmp_path, data_root):
    """An mlp + cls model in the Trainer: preempted after its step-granular
    'last' save and resumed from it, its weights, running buffers and
    optimizer state equal an uninterrupted run's bit for bit; cli.evaluate
    on that run's 'last' checkpoint equals the in-memory evaluation."""
    extra = {**MLP, **CLS}
    data = synthetic.open_synthetic(data_root, Config.from_overrides(TINY).data)
    full = Trainer(_run_cfg(tmp_path, "full", extra, epochs=2), train_data=data,
                   val_data=data, device="cpu")
    full.fit()
    cfg = _run_cfg(tmp_path, "pre", extra, epochs=2, checkpoint_every_steps=2,
                   abort_at_step=5)
    first = Trainer(cfg, train_data=data, val_data=data, device="cpu")
    with pytest.raises(Preempted):
        first.fit()
    saved = first.ckpt.restore("last")["params"]
    assert {n for n in saved if n.endswith(("running_mean", "running_var"))} == set(
        _buffers(first.model))
    resumed = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, resume="last",
                                                            abort_at_step=0)),
                      train_data=data, val_data=data, device="cpu")
    resumed.fit()
    init = MaDe(cfg, torch.Generator().manual_seed(cfg.train.seed))
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, full.model.state_dict()[name]), name
        if name.endswith(("running_mean", "running_var")):
            assert not torch.equal(value, init.state_dict()[name]), name
    for key in ("mu", "nu"):
        got, want = resumed.optimizer.state_dict()[key], full.optimizer.state_dict()[key]
        assert all(torch.equal(got[n], want[n]) for n in want), key

    in_memory = evaluate(resumed.model, data, cfg)
    want = {**in_memory["retrieval"], **in_memory["localization"],
            **in_memory["composite"]}
    want.pop("cols", None)
    results = evaluate_cli.main([
        "--device", "cpu", "--ckpt", "last", "--run-dir", resumed.run_dir, "--split", "val",
        *_args({**TINY, **extra, "train.batch_size_val": 16,
                "data.val_csv": os.path.join(data_root, "data.csv"),
                "data.feature_root": data_root})])
    assert results["last"] == want


@pytest.mark.parametrize("case", ["transf", "none", "mlp", "cls", "mlp_cls"])
def test_reference_format_refused_where_jax_refuses(case, tmp_path):
    """`--export-torch`, save_reference_bin and load_reference_bin refuse
    exactly the configurations JAX's torch export and import refuse."""
    extra = {"transf": {}, **CASES}[case]
    cfg, jcfg = _configs(extra)
    jax_refuses = []
    for fn in (export_uni_state_dict, import_uni_state_dict):
        try:
            fn({}, jcfg)
        except NotImplementedError:
            jax_refuses.append(True)
        except KeyError:                   # past the check, into the empty tree
            jax_refuses.append(False)
    assert jax_refuses in ([True, True], [False, False])
    model = MaDe(cfg)
    path = str(tmp_path / "made.bin")
    run_dir = str(tmp_path / "run")
    CheckpointManager(run_dir).save("last", {"params": model.state_dict(), "step": 0,
                                             "epoch": 1})
    export = lambda: evaluate_cli.main(["--device", "cpu", "--ckpt", "last", "--run-dir",
                                        run_dir, "--export-torch", path, *_args(
                                            {**TINY, **extra})])
    if jax_refuses[0]:
        for fn in (lambda: check_reference_format(cfg), export,
                   lambda: save_reference_bin(model, cfg, path),
                   lambda: load_reference_bin(path, cfg)):
            with pytest.raises(NotImplementedError, match="no reference-format checkpoint"):
                fn()
        assert not os.path.exists(path)
        return
    export()
    for name, value in load_reference_bin(path, cfg).state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name


# ------------------------------------------------------------------ serving


def _music(cfg, n=10, seed=4):
    rng = np.random.default_rng(seed)
    s, f = cfg.data.max_snippet_num, cfg.data.max_v_frames
    ragged = lambda rows, length, lo: (np.arange(length)[None] < rng.integers(
        lo, length + 1, rows)[:, None]).astype(np.float32)
    return dict(ids=[f"m{i}" for i in range(n)],
                feats=rng.standard_normal((n, s, cfg.data.ast_dim), dtype=np.float32),
                masks=ragged(n, s, 1),
                frames=rng.standard_normal((3, f, cfg.data.vit_dim), dtype=np.float32),
                fmask=ragged(3, f, 2))


def _assert_same_results(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["music_ids"] == b["music_ids"]
        for k, atol in (("retrieval_scores", SCORE_ATOL), ("moment_scores", SCORE_ATOL),
                        ("moments", SPAN_ATOL)):
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


def test_cls_engine_matches_jax():
    """A cls-token model served: the index (tokens and masks without the cls
    row) and three queries' ids, scores and moments against JAX's engine
    (plain path), the video duration from the raw frame mask."""
    cfg, jcfg = _configs(CLS)
    variables = _jax_variables(CLS)
    model = load_jax_params(MaDe(cfg), variables, cfg).eval()
    w = _music(cfg)
    jindex = jengine.build_music_index(JaxMaDe(jcfg), variables, jcfg, w["ids"], w["feats"],
                                       w["masks"], batch_size=4)
    index = tengine.build_music_index(model, w["ids"], w["feats"], w["masks"], batch_size=4)
    assert index.seg_tokens.shape == (10, cfg.data.max_snippet_num, cfg.model.dim_input)
    np.testing.assert_array_equal(index.seg_masks, w["masks"])
    for field in ("music_embs", "seg_tokens", "seg_masks"):
        _close(getattr(index, field), getattr(jindex, field), field, OUT_ATOL, OUT_RTOL)
    want = jengine.RetrievalEngine(JaxMaDe(jcfg), variables, jcfg, jindex, sim_block_size=4,
                                   use_fused_kernels=False).query(w["frames"], w["fmask"],
                                                                  top_k=3)
    for fused in (False, True):
        got = tengine.RetrievalEngine(model, cfg, index, sim_block_size=4,
                                      use_fused_kernels=fused).query(w["frames"], w["fmask"],
                                                                     top_k=3)
        _assert_same_results(got, want)


def test_mlp_engine_refused_where_jax_fails():
    """JAX's engine fails on an EmbeddingNet model (it hands the towers no
    batch_stats: ScopeCollectionNotFound); the port's index build and engine
    raise ValueError naming that.  If JAX's engine ever serves it, this
    test says so."""
    cfg, jcfg = _configs(MLP)
    variables = _jax_variables(MLP)
    w = _music(cfg, n=4)
    with pytest.raises(ScopeCollectionNotFound, match="bn1_mean"):
        jengine.build_music_index(JaxMaDe(jcfg), variables, jcfg, w["ids"], w["feats"],
                                  w["masks"], batch_size=4)
    model = load_jax_params(MaDe(cfg), variables, cfg)
    with pytest.raises(ValueError, match="ScopeCollectionNotFound"):
        tengine.build_music_index(model, w["ids"], w["feats"], w["masks"])
    plain_cfg, _ = _configs({})
    index = tengine.build_music_index(MaDe(plain_cfg), w["ids"], w["feats"], w["masks"])
    with pytest.raises(ValueError, match="agg_module='mlp'"):
        tengine.RetrievalEngine(model, cfg, index)


@pytest.mark.parametrize("case", ["default", "cls", "mlp"])
def test_cli_index_from_run_dir(case, tmp_path, capsys):
    """cli.index build and query with `--ckpt last --run-dir`: on a default
    model the index file and the reply equal the `.bin` path's; a cls model
    is served as the in-memory engine serves it; an mlp model's build raises
    the engine's ValueError."""
    extra = {"default": {}, "cls": CLS, "mlp": MLP}[case]
    cfg, _ = _configs(extra)
    model = MaDe(cfg, torch.Generator().manual_seed(5)).eval()
    w = _music(cfg, seed=6)
    PackedFeatureStore.build(str(tmp_path / "music"), w["ids"],
                             {"feats": w["feats"], "mask": w["masks"]})
    PackedFeatureStore.build(str(tmp_path / "video"), ["v0", "v1", "v2"],
                             {"feats": w["frames"], "mask": w["fmask"]})
    run_dir = str(tmp_path / "run")
    CheckpointManager(run_dir).save("last", {"params": model.state_dict(), "step": 0,
                                             "epoch": 1})
    sources = {"run": ["--ckpt", "last", "--run-dir", run_dir]}
    if case == "default":
        sources["bin"] = ["--ckpt", str(tmp_path / "made.bin")]
        save_reference_bin(model, cfg, str(tmp_path / "made.bin"))
    common = ["--device", "cpu", *_args({**TINY, **extra})]
    if case == "mlp":
        with pytest.raises(ValueError, match="agg_module='mlp'"):
            index_cli.main(["build", "--music-store", str(tmp_path / "music"), "--out",
                            str(tmp_path / "never.npz"), *sources["run"], *common])
        return
    replies, indexes = {}, {}
    for name, src in sources.items():
        path = str(tmp_path / f"{name}.npz")
        index_cli.main(["build", "--music-store", str(tmp_path / "music"), "--out", path,
                        *src, *common])
        assert json.loads(capsys.readouterr().out)["tracks"] == len(w["ids"])
        indexes[name] = tengine.MusicIndex.load(path)
        index_cli.main(["query", "--index", path, "--video-store", str(tmp_path / "video"),
                        "--video-id", "v1", "--top-k", "3", *src, *common])
        replies[name] = json.loads(capsys.readouterr().out)
    if case == "default":
        assert replies["run"] == replies["bin"]
        for field in ("music_embs", "seg_tokens", "seg_masks"):
            np.testing.assert_array_equal(getattr(indexes["run"], field),
                                          getattr(indexes["bin"], field))
    want = tengine.RetrievalEngine(model, cfg, tengine.build_music_index(
        model, w["ids"], w["feats"], w["masks"])).query(w["frames"][1:2], w["fmask"][1:2],
                                                        top_k=3)
    assert replies["run"]["video_id"] == "v1"
    _assert_same_results([{k: v for k, v in replies["run"].items() if k != "video_id"}],
                         want)
