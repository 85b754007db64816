"""The port's fused temporal-tower layer (ops/cuda/fused_temporal_layer.py),
its Philox masks, `FusedTemporalTransformer` and the `fused_temporal=True`
model and training step, against the JAX package on the CPU.

On the CPU the wrapper runs its plain version (the layer's own forward with
the Philox masks of `philox.temporal_masks`).  It is held against JAX's
Pallas kernels in interpret mode at rate 0 (`fused_temporal_layer_train`,
forward and backward) and against the mask-fixed JAX oracle
`temporal_layer_fwd_with_masks` at rate 0.8, fed the same masks.
Tolerances: forward 3e-5 abs (float32 on both sides, outputs of order 1
after LN2; the Pallas kernel's rational erf differs from erf by ~1e-7);
gradients 2e-4 abs, JAX's own tolerance for its fused layers' VJPs (sums
over the rows in another order).  Weights move across through the port's
JAX key map (interop/state_dict.py::_temporal, which load_jax_params uses).
The CUDA kernels themselves are held against the plain version on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import dataclasses
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.models.made import MaDe as JaxMaDe, Tower
from mgsv_tpu.models.temporal import FusedTemporalTransformer as JaxFusedTemporal
from mgsv_tpu.ops.pallas.fused_temporal_layer import (fused_temporal_layer_train,
                                                      temporal_layer_fwd_with_masks)
from mgsv_tpu_torch.cli import train as train_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import _temporal, jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.models.temporal import (FusedTemporalTransformer, TemporalLayer,
                                            TemporalTransformer)
from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.serve.engine import RetrievalEngine, build_music_index
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step

ATOL = 3e-5
VJP_ATOL = 2e-4
D, HEADS, F = 32, 4, 64


def inputs(b, L, seed, dead_row=False):
    """x [B, L, D] and a ragged mask whose first row keeps only its first
    key (and, with dead_row, whose last row keeps none)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, D), dtype=np.float32)
    mask = (np.arange(L)[None] < rng.integers(1, L + 1, b)[:, None]).astype(np.float32)
    mask[0] = 0
    mask[0, 0] = 1
    if dead_row:
        mask[-1] = 0
    return x, mask


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def tower_tree(depth, seed, b=2, L=5):
    """A perturbed JAX FusedTemporalTransformer tree (TemporalTransformer's)."""
    mod = JaxFusedTemporal(D, depth, HEADS, F, D)
    tree = mod.init(jax.random.PRNGKey(0), jnp.zeros((b, L, D)), jnp.ones((b, L)),
                    deterministic=True)["params"]
    return perturbed(jax.device_get(tree), seed)


def port_state(tree, depth):
    out = {}
    _temporal(out, "t", tree, depth)
    return {k[2:]: torch.from_numpy(np.array(v)) for k, v in out.items()}


def layer_pair(seed):
    """(JAX params of fused_temporal_layer_train, the port's TemporalLayer,
    the JAX tree) for one layer."""
    tree = tower_tree(1, seed)
    jp = {"norm1": tree["norm1_0"], "self_attn": tree["attn_0"], "norm2": tree["norm2_0"],
          "linear1": tree["ff_fc1_0"], "linear2": tree["ff_fc2_0"]}
    layer = TemporalLayer(D, HEADS, F, 0.0)
    state = port_state(tree, 1)
    layer.load_state_dict({k[len("layers.0."):]: v for k, v in state.items()
                           if k.startswith("layers.0.")}, strict=True)
    return jp, layer, tree


def layer_grad_state(dp, tree):
    """JAX layer gradients -> the port's TemporalLayer parameter names."""
    g = {"norm1_0": dp["norm1"], "attn_0": dp["self_attn"], "norm2_0": dp["norm2"],
         "ff_fc1_0": dp["linear1"], "ff_fc2_0": dp["linear2"],
         "final_linear": tree["final_linear"]}
    return {k[len("layers.0."):]: v for k, v in port_state(g, 1).items()
            if k.startswith("layers.0.")}


def port_vjp(layer, x, mask, g, rate, seed):
    xt = torch.from_numpy(x).requires_grad_()
    out = ftl.fused_temporal_layer(xt, torch.from_numpy(mask), layer, rate, seed)
    out.backward(torch.from_numpy(g))
    grads = {"x": xt.grad.numpy()}
    grads.update({n: p.grad.numpy() for n, p in layer.named_parameters()})
    return out.detach().numpy(), grads


def assert_grads(grads, dx, dp, tree, atol):
    np.testing.assert_allclose(grads["x"], np.asarray(dx), atol=atol, rtol=0)
    want = layer_grad_state(dp, tree)
    assert want.keys() == grads.keys() - {"x"}
    for name, ref in want.items():
        np.testing.assert_allclose(grads[name], ref.numpy(), atol=atol, rtol=0, err_msg=name)


@pytest.mark.kernel
@pytest.mark.parametrize("b,L", [(3, 10), (6, 21)])
def test_plain_version_matches_pallas_kernels_at_rate_0(b, L):
    """Forward and every gradient against JAX's custom VJP: the forward and
    backward Pallas kernels in interpret mode."""
    x, mask = inputs(b, L, seed=b + L)
    jp, layer, tree = layer_pair(seed=L)
    g = np.random.default_rng(L + 1).standard_normal((b, L, D), dtype=np.float32)
    seed = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(lambda p_, x_: fused_temporal_layer_train(
        p_, x_, jnp.asarray(mask), seed, HEADS, 1, True, 0.0), jp, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    out, grads = port_vjp(layer, x, mask, g, 0.0, 0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    assert_grads(grads, dx, dp, tree, VJP_ATOL)
    assert ftl.fused_temporal_layer.launches == ftl.fused_temporal_layer_bwd.launches == 0


@pytest.mark.kernel
@pytest.mark.parametrize("rate", [0.0, 0.8])
def test_plain_version_matches_the_oracle_with_the_same_masks(rate):
    """Forward and jax.vjp gradients of temporal_layer_fwd_with_masks, fed
    the port's Philox masks as numpy; a row with no valid key included
    (uniform attention weights on both sides)."""
    b, L, seed = 4, 13, 77
    x, mask = inputs(b, L, seed=3, dead_row=True)
    jp, layer, tree = layer_pair(seed=5)
    g = np.random.default_rng(6).standard_normal((b, L, D), dtype=np.float32)
    masks = None
    if rate > 0.0:
        masks = {k: jnp.asarray(v.numpy())
                 for k, v in philox.temporal_masks(seed, b, L, D, F, HEADS, rate).items()}
    ref, vjp = jax.vjp(lambda p_, x_: temporal_layer_fwd_with_masks(
        p_, x_, jnp.asarray(mask), masks, HEADS), jp, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    out, grads = port_vjp(layer, x, mask, g, rate, seed)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=VJP_ATOL, rtol=0)
    assert_grads(grads, dx, dp, tree, VJP_ATOL)
    if rate > 0.0:                     # dropout really acted
        _, plain = port_vjp(layer, x, mask, g, 0.0, seed)
        assert np.abs(plain["x"] - grads["x"]).max() > 10 * VJP_ATOL


def test_temporal_masks_use_the_documented_streams():
    """attn[b, h] is stream (b, h); ffn1 stream (b, H); ffn2 stream (b, H+1);
    elements row-major; the same (seed, row, site) gives the same bits."""
    b, L, d, f, h, rate, seed = 2, 3, 8, 16, 2, 0.8, 42
    masks = philox.temporal_masks(seed, b, L, d, f, h, rate)
    assert (masks["attn"].shape, masks["ffn1"].shape, masks["ffn2"].shape) == (
        (b, h, L, L), (b, L, f), (b, L, d))
    km = lambda a, s, n: philox.keep_mask(seed, torch.tensor([a]), torch.tensor([s]), n, rate)[0]
    torch.testing.assert_close(masks["attn"][1, 1].reshape(-1), km(1, 1, L * L))
    torch.testing.assert_close(masks["attn"][0, 0].reshape(-1), km(0, 0, L * L))
    torch.testing.assert_close(masks["ffn1"][1].reshape(-1), km(1, h, L * f))
    torch.testing.assert_close(masks["ffn2"][0].reshape(-1), km(0, h + 1, L * d))
    again = philox.temporal_masks(seed, b, L, d, f, h, rate)
    for k in masks:
        assert torch.equal(masks[k], again[k])


def test_temporal_masks_keep_rate_and_independence():
    """At 0.8 the keep share is 0.2 within 4 sigma; two rows, two sites and
    two seeds agree on a keep decision as often as independent coins do
    (p^2 + (1-p)^2, within 4 sigma)."""
    b, L, d, f, h, rate = 8, 50, 256, 1024, 8, 0.8
    masks = philox.temporal_masks(3, b, L, d, f, h, rate)
    kept = torch.cat([(m > 0).float().reshape(-1) for m in masks.values()])
    sigma = np.sqrt(rate * (1 - rate) / kept.numel())
    assert abs(kept.mean().item() - (1 - rate)) <= 4 * sigma
    assert set(torch.unique(masks["ffn1"]).tolist()) == {0.0, philox.keep_scale(rate)}
    other_seed = philox.temporal_masks(4, b, L, d, f, h, rate)
    n = L * d
    expect = (1 - rate) ** 2 + rate ** 2
    sig = np.sqrt(expect * (1 - expect) / n)
    agree = lambda m1, m2: ((m1 > 0) == (m2 > 0)).float().mean().item()
    pairs = [(masks["ffn2"][0], masks["ffn2"][1]),                          # rows
             (masks["ffn2"][0], masks["ffn1"][0, :, :d]),                   # sites
             (masks["ffn2"][0], other_seed["ffn2"][0]),                     # seeds
             (masks["attn"][0, 0].reshape(-1), masks["attn"][0, 1].reshape(-1))]  # heads
    for m1, m2 in pairs:
        s = sig * np.sqrt(n / m1.numel())
        assert abs(agree(m1, m2) - expect) <= 4 * s


@pytest.mark.kernel
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fused_tower_matches_jax_fused_temporal_transformer(dtype):
    """The port's FusedTemporalTransformer (two layers) against JAX's, on one
    tree, forward and gradients at rate 0 (JAX: Pallas kernels in interpret
    mode).  A bf16 compute dtype is ignored on both sides, with a warning:
    float32 tolerances hold, while the plain bf16 tower is farther off."""
    depth, b, L = 2, 3, 11
    tree = tower_tree(depth, seed=9)
    x, mask = inputs(b, L, seed=10)
    g = np.random.default_rng(11).standard_normal((b, L, D), dtype=np.float32)
    jmod = JaxFusedTemporal(D, depth, HEADS, F, D, dtype=None if dtype is None else jnp.bfloat16)
    ref, vjp = jax.vjp(lambda p_, x_: jmod.apply({"params": p_}, x_, jnp.asarray(mask),
                                                 deterministic=True), tree, jnp.asarray(x))
    dtree, dx = vjp(jnp.asarray(g))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trm = FusedTemporalTransformer(D, depth, HEADS, F, D, compute_dtype=dtype)
    assert len(caught) == (dtype is not None)
    trm.load_state_dict(port_state(tree, depth), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = trm(xt, torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=VJP_ATOL, rtol=0)
    want = port_state(jax.device_get(dtree), depth)
    for name, p in trm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=VJP_ATOL, rtol=0,
                                   err_msg=name)
    if dtype is not None:
        plain = TemporalTransformer(D, depth, HEADS, F, D, compute_dtype=dtype)
        plain.load_state_dict(trm.state_dict())
        with torch.no_grad():
            bf16 = plain(torch.from_numpy(x), torch.from_numpy(mask))
        assert np.abs(bf16.numpy() - np.asarray(ref)).max() > 10 * ATOL


TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.temporal_heads": 4, "model.fused_temporal": True}
NO_DROPOUT = {"model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0,
              "model.detr_dropout": 0.0}


def _configs(**extra):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)


def _jax_params(jcfg, seed=0):
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(seed))
    return perturbed(jax.device_get(params), seed + 1)


def test_jax_fused_tree_loads_into_the_port_fused_model():
    """A JAX MaDe built with fused_temporal=True loads strictly into the
    port's MaDe, whose towers are then FusedTemporalTransformers."""
    cfg, jcfg = _configs(**{"model.compute_dtype": "float32"})
    params = _jax_params(jcfg)
    model = load_jax_params(MaDe(cfg), params, cfg)
    assert isinstance(model.video_transformer, FusedTemporalTransformer)
    assert isinstance(model.audio_transformer, FusedTemporalTransformer)
    state = jax_tree_to_state_dict(params, cfg)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), state[name], err_msg=name)


@pytest.mark.kernel
def test_bf16_fused_towers_run_float32_as_jax_does():
    """fused_temporal=True under the default bf16 compute dtype: the port's
    towers give JAX's fused Tower (which ignores the dtype) to float32
    tolerance, and MaDe warns that the dtype is ignored; the same weights
    in the plain bf16 towers land farther off."""
    cfg, jcfg = _configs(**{"model.compute_dtype": "bfloat16"})
    params = _jax_params(jcfg)
    with pytest.warns(UserWarning, match="ignores compute dtype"):
        model = load_jax_params(MaDe(cfg), params, cfg)
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                   fused_temporal=False))
    plain = load_jax_params(MaDe(plain_cfg), params, plain_cfg)
    m, data = jcfg.model, jcfg.data
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((4, data.max_v_frames, data.vit_dim), dtype=np.float32)
    mask = (np.arange(data.max_v_frames)[None] < rng.integers(1, 13, 4)[:, None]).astype(
        np.float32)
    jt = Tower(m.dim_input, m.video_pe_len, m.temporal_depth, m.temporal_heads,
               m.temporal_mlp_dim, m.temporal_dropout, dtype=jnp.bfloat16, fused=True)
    ref = jt.apply({"params": params["params"]["video_tower"]}, jnp.asarray(feats),
                   jnp.asarray(mask))
    with torch.no_grad():
        got = model.video_tower(torch.from_numpy(feats), torch.from_numpy(mask))
        bf16 = plain.video_tower(torch.from_numpy(feats), torch.from_numpy(mask))
    for out, r in zip(got[:2], ref[:2]):
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    assert np.abs(bf16[0].numpy() - np.asarray(ref[0])).max() > 10 * ATOL


@pytest.mark.kernel
def test_made_forward_with_fused_temporal_matches_jax():
    """MaDe.forward (no dropout) with fused_temporal=True, float32, against
    the JAX model: towers, X-Pool similarity and DETR heads."""
    cfg, jcfg = _configs(**{"model.compute_dtype": "float32"})
    params = _jax_params(jcfg)
    model = load_jax_params(MaDe(cfg), params, cfg)
    batch = example_batch(np.random.RandomState(2), cfg, 6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = JaxMaDe(jcfg).apply(params, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                              jb["segment_mask"], v_duration=jb["v_duration"],
                              deterministic=True)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"], v_duration=tb["v_duration"])
    for key in ("frame_tokens", "seg_tokens", "video_emb", "music_emb", "memory",
                "pred_logits_layers", "pred_spans_layers"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


@pytest.mark.kernel
def test_train_step_with_fused_temporal_matches_jax():
    """One make_train_step with fused_temporal=True, float32, every dropout
    at 0, against JAX's value_and_grad of the same loss (its temporal
    layers on the Pallas kernels in interpret mode).  Loss rtol 1e-5;
    gradients atol 1e-5 plus rtol 1e-4, as tests/test_torch_port_train.py
    holds the plain step."""
    from mgsv_tpu.train.objective import total_loss as jax_total_loss

    cfg, jcfg = _configs(**NO_DROPOUT, **{"model.compute_dtype": "float32",
                                          "train.scheduler": "constant"})
    batch = example_batch(np.random.RandomState(0), cfg, 8)
    params = _jax_params(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxMaDe(jcfg)

    def loss_fn(p):
        out = jmodel.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                           jb["segment_mask"], v_duration=jb["v_duration"],
                           deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_total_loss(out, jb["spans_target"], jcfg)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = load_jax_params(MaDe(cfg), params, cfg)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, 100))
    with mock.patch.object(ftl, "fused_temporal_layer",
                           wraps=ftl.fused_temporal_layer) as calls:
        log = step(to_tensors(batch, "cpu"))
    assert calls.call_count == 2                     # one layer per tower
    np.testing.assert_allclose(float(log["loss"]), float(loss), rtol=1e-5)
    want = jax_tree_to_state_dict(jax.device_get(grads), cfg)
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=1e-4, err_msg=name)


def test_train_step_with_fused_temporal_dropout_is_seeded():
    """Dropout 0.8 in the fused towers: two steps from the same weights give
    the same losses, and other losses than without dropout."""
    cfg, _ = _configs(**{"model.compute_dtype": "float32", "train.scheduler": "constant"})
    batch = to_tensors(example_batch(np.random.RandomState(1), cfg, 8), "cpu")
    runs = []
    for c in (cfg, dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, temporal_dropout=0.0)), cfg):
        model = MaDe(c, torch.Generator().manual_seed(0))
        step = make_train_step(model, c, make_optimizer(model, c, 100))
        runs.append([float(step(batch)["loss"]) for _ in range(2)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[2]
    assert runs[0][0] != runs[1][0]


def test_serving_runs_the_plain_towers_as_jax_does():
    """The JAX engine builds its towers without `fused`: the port's engine on
    a fused_temporal model gives the same index and answers as on the plain
    model with the same weights (bf16 towers), not the fused float32 ones."""
    cfg, _ = _configs(**{"model.compute_dtype": "bfloat16"})
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                   fused_temporal=False))
    with pytest.warns(UserWarning):
        fused = MaDe(cfg, torch.Generator().manual_seed(0))
    plain = MaDe(plain_cfg)
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(13)
    s, f = cfg.data.max_snippet_num, cfg.data.max_v_frames
    feats = rng.standard_normal((6, s, cfg.data.ast_dim), dtype=np.float32)
    masks = np.ones((6, s), np.float32)
    ids = [f"m{i}" for i in range(6)]
    idx_f = build_music_index(fused, ids, feats, masks)
    idx_p = build_music_index(plain, ids, feats, masks)
    np.testing.assert_array_equal(idx_f.seg_tokens, idx_p.seg_tokens)
    videos = rng.standard_normal((2, f, cfg.data.vit_dim), dtype=np.float32)
    vmask = np.ones((2, f), np.float32)
    got = RetrievalEngine(fused, cfg, idx_f).query(videos, vmask, top_k=3)
    assert got == RetrievalEngine(plain, plain_cfg, idx_p).query(videos, vmask, top_k=3)
    with torch.no_grad():
        tokens = fused.music_tower(torch.from_numpy(feats), torch.from_numpy(masks))[0]
    assert np.abs(tokens.numpy() - idx_f.seg_tokens).max() > 1e-4


def test_train_cli_takes_fused_temporal(tmp_path):
    """`cli.train --model.fused_temporal true` on the CPU at the verify
    skill's small shapes: the flag reaches MaDe, and every step and every
    evaluation batch goes through the fused layer, once per tower."""
    args = ["--device", "cpu", "--synthetic", "32", "--train.epochs", "1",
            "--train.output_dir", str(tmp_path), "--train.batch_size_train", "16",
            "--train.batch_size_val", "16", "--model.compute_dtype", "float32"]
    for k, v in TINY.items():
        args += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    with mock.patch.object(ftl, "fused_temporal_layer",
                           wraps=ftl.fused_temporal_layer) as calls:
        result = train_cli.main(args)
    assert len(result["history"]) == 1
    assert calls.call_count == 2 * 2 + 2 * 2       # 2 steps + 2 eval batches, 2 towers each
    assert {c.args[3] for c in calls.call_args_list} == {0.0, 0.8}


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    layer = TemporalLayer(256, 8, 1024, 0.0)
    x = torch.zeros(1, 4, 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftl.fused_temporal_layer_bwd(x, torch.ones(1, 4), x, layer)
    assert ftl.fused_temporal_layer_bwd.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "mask_dtype", "shape", "head_dim", "width",
                                 "length", "contiguous", "layer_dim"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    b, L, d, heads = 2, 16, 256, 8
    layer = TemporalLayer(d, heads, 4 * d, 0.0)
    x, mask = torch.zeros(b, L, d), torch.ones(b, L)
    if bad == "dtype":
        x = x.double()
    elif bad == "mask_dtype":
        mask = mask.bool()
    elif bad == "shape":
        mask = torch.ones(b, L + 1)
    elif bad == "head_dim":
        layer = TemporalLayer(d, 4, 4 * d, 0.0)
    elif bad == "width":
        layer = TemporalLayer(d, heads, 3 * d // 2, 0.0)
    elif bad == "length":
        x, mask = torch.zeros(b, ftl.MAX_L + 1, d), torch.ones(b, ftl.MAX_L + 1)
    elif bad == "contiguous":
        x = torch.zeros(b, d, L).transpose(1, 2)
    else:                              # the layer's width differs from the input's
        layer = TemporalLayer(d // 2, heads, 4 * d, 0.0)
    with pytest.raises(ValueError, match="fused_temporal_layer"):
        ftl.check_supported(x, mask, layer)
    ftl.check_supported(torch.zeros(b, ftl.MAX_L, d), torch.ones(b, ftl.MAX_L),
                        TemporalLayer(d, heads, 4 * d, 0.0))


def test_weight_check_runs_again_after_the_weights_move():
    layer = TemporalLayer(256, 8, 1024, 0.0)
    cpu = torch.device("cpu")
    assert ftl._weights(layer, cpu)[0] is layer[1].in_proj_weight
    assert layer in ftl._checked_weights
    layer.double()                     # new storage: the check runs again and fails
    with pytest.raises(ValueError):
        ftl._weights(layer, cpu)
