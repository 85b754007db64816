"""PyTorch port vs the JAX package: layers, temporal tower, X-Pool, towers,
DETR, heads and similarities, at small widths and in float32.

One JAX MaDe init per module; its parameters reach the port through
`load_jax_params` (the reference state-dict names, strict).  Inputs come
from numpy seeds and go through both sides.  Tolerance 1e-5: both sides
compute in float32 (JAX matmuls at "highest", torch on the CPU), so only
summation order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config, DataConfig, ModelConfig
from mgsv_tpu.eval import similarity as jsim
from mgsv_tpu.models import layers as jL
from mgsv_tpu.models.detr import DetrDecoderLayer, DetrEncoderLayer, DetrTransformer
from mgsv_tpu.models.made import MaDe as JaxMaDe, Tower
from mgsv_tpu.models.temporal import TemporalTransformer
from mgsv_tpu.models.xpool import XPoolTransformer, sim_matrix_music_pooling
from mgsv_tpu.ops import spans as jspans
from mgsv_tpu_torch.eval import similarity as tsim
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.models import layers as tL
from mgsv_tpu_torch.models import xpool as txpool
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops import spans as tspans

ATOL = 1e-5


def small_cfg(**model_overrides) -> Config:
    data = DataConfig(max_v_frames=8, stride=30.0, filter_sec=30.0,
                      vit_dim=32, ast_dim=48)
    model = ModelConfig(dim_input=16, temporal_mlp_dim=32, detr_ffn_dim=32,
                        detr_enc_layers=1, detr_dec_layers=2,
                        temporal_heads=4, detr_heads=4, contrastive_dim=16,
                        video_pe_len=16, audio_pe_len=16, compute_dtype="float32",
                        fused_detr_encoder=False, fused_xpool_sim=False,
                        **model_overrides)
    return dataclasses.replace(Config(), data=data, model=model)


def ragged(rng, rows, length, lo=1):
    lens = rng.integers(lo, length + 1, rows)
    return (np.arange(length)[None] < lens[:, None]).astype(np.float32)


def jax_init(cfg, seed=0):
    f, s = cfg.data.max_v_frames, cfg.data.max_snippet_num
    init = jax.jit(lambda key, *a: JaxMaDe(cfg).init(key, *a, deterministic=True))
    return init(jax.random.PRNGKey(seed),
                jnp.zeros((1, f, cfg.data.vit_dim)), jnp.ones((1, f)),
                jnp.zeros((1, s, cfg.data.ast_dim)), jnp.ones((1, s)))


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX init, perturbed JAX params, port MaDe with those params).
    The perturbation moves every parameter off its init (identity X-Pool,
    unit LayerNorms), so a swapped or transposed weight cannot pass."""
    cfg = small_cfg()
    init = jax_init(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), init)
    model = load_jax_params(MaDe(cfg), params, cfg).eval()
    return cfg, init, params["params"], model


def t(x):
    return torch.from_numpy(np.array(x))


def close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("multiple", [1, 8])
def test_pad_and_position_embedding(multiple):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 13, 16), dtype=np.float32)
    mask = ragged(rng, 4, 13)
    mask[2] = 0                                  # a fully masked row
    jx, jm = jL.pad_fused_sequence(jnp.asarray(x), jnp.asarray(mask), multiple)
    tx, tm = tL.pad_fused_sequence(t(x), t(mask), multiple)
    close(tx, jx, 0)
    close(tm, jm, 0)
    close(tL.position_embedding_sine(tm, 16), jL.position_embedding_sine(jm, 16))


def test_norms_pooling_and_activations():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 8), dtype=np.float32)
    x[1, 2] = 0.0                                # zero vector: eps clamp
    mask = ragged(rng, 3, 5)
    close(tL.l2_normalize(t(x)), jL.l2_normalize(jnp.asarray(x)))
    close(tL.masked_mean(t(x), t(mask)), jL.masked_mean(jnp.asarray(x), jnp.asarray(mask)))
    close(tL.quick_gelu(t(x)), jL.quick_gelu(jnp.asarray(x)))
    np.testing.assert_array_equal(tL.sinusoidal_table(7, 10), jL.sinusoidal_table(7, 10))


def test_span_conversions():
    rng = np.random.default_rng(3)
    cw = rng.uniform(0, 1, (4, 3, 2)).astype(np.float32)
    close(tspans.span_cw_to_se(t(cw)), jspans.span_cw_to_se(jnp.asarray(cw)))
    close(tspans.span_se_to_cw(t(cw)), jspans.span_se_to_cw(jnp.asarray(cw)))


@pytest.mark.parametrize("which", ["video", "audio"])
def test_temporal_transformer(pair, which):
    cfg, _, p, model = pair
    m = cfg.model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, m.dim_input), dtype=np.float32)
    mask = ragged(rng, 3, 7)
    jmod = TemporalTransformer(m.dim_input, m.temporal_depth, m.temporal_heads,
                               m.temporal_mlp_dim, m.dim_input)
    ref = jmod.apply({"params": p[f"{which}_tower"]["temporal"]},
                     jnp.asarray(x), jnp.asarray(mask))
    trm = model.video_transformer if which == "video" else model.audio_transformer
    close(trm(t(x), t(mask)), ref)


@pytest.mark.parametrize("which", ["video", "music"])
def test_tower(pair, which):
    cfg, _, p, model = pair
    m, data = cfg.model, cfg.data
    rng = np.random.default_rng(5)
    if which == "video":
        length, in_dim, pe_len, sub = data.max_v_frames, data.vit_dim, m.video_pe_len, "video_tower"
        run = model.video_tower
    else:
        length, in_dim, pe_len, sub = (data.max_snippet_num, data.ast_dim, m.audio_pe_len,
                                       "audio_tower")
        run = model.music_tower
    feats = rng.standard_normal((4, length, in_dim), dtype=np.float32)
    mask = ragged(rng, 4, length)
    jt = Tower(m.dim_input, pe_len, m.temporal_depth, m.temporal_heads,
               m.temporal_mlp_dim, m.temporal_dropout)
    refs = jt.apply({"params": p[sub]}, jnp.asarray(feats), jnp.asarray(mask))
    for out, ref in zip(run(t(feats), t(mask)), refs):
        close(out, ref)


@pytest.mark.parametrize("masked", [True, False])
def test_xpool(pair, masked):
    cfg, _, p, model = pair
    d = cfg.model.dim_input
    rng = np.random.default_rng(6)
    xp = p["xpool_v2m"]
    video = rng.standard_normal((3, d), dtype=np.float32)
    segs = rng.standard_normal((5, 4, d), dtype=np.float32)
    mask = ragged(rng, 5, 4) if masked else None
    ref = XPoolTransformer(d).apply({"params": xp}, jnp.asarray(video), jnp.asarray(segs),
                                    None if mask is None else jnp.asarray(mask))
    out = model.xpool(t(video), t(segs), None if mask is None else t(mask))
    close(out, ref)
    close(txpool.sim_matrix_music_pooling(t(video), out),
          sim_matrix_music_pooling(jnp.asarray(video), ref))


def test_detr_layers_and_transformer(pair):
    cfg, _, p, model = pair
    m = cfg.model
    d = m.dim_input
    rng = np.random.default_rng(7)
    b, L = 3, 12
    src = rng.standard_normal((b, L, d), dtype=np.float32)
    mask = ragged(rng, b, L)
    pos = np.asarray(jL.position_embedding_sine(jnp.asarray(mask), d))
    tgt = rng.standard_normal((b, 1, d), dtype=np.float32)
    qpos = np.broadcast_to(np.asarray(p["query_embed"])[None], (b, 1, d)).copy()
    pd = p["detr"]
    detr = model.detr_transformer

    enc = DetrEncoderLayer(d, m.detr_heads, m.detr_ffn_dim, 0.0).apply(
        {"params": pd["enc_0"]}, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(pos))
    close(detr.encoder.layers[0](t(src), t(mask), t(pos)), enc)

    dec = DetrDecoderLayer(d, m.detr_heads, m.detr_ffn_dim, 0.0, self_attn=True).apply(
        {"params": pd["dec_0"]}, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(mask),
        jnp.asarray(pos), jnp.asarray(qpos))
    close(detr.decoder.layers[0](t(tgt), t(src), t(mask), t(pos), t(qpos)), dec)

    jd = DetrTransformer(d, m.detr_heads, m.detr_ffn_dim, m.detr_enc_layers,
                         m.detr_dec_layers, decoder_self_attn=m.decoder_self_attn)
    hid, mem = jd.apply({"params": pd}, jnp.asarray(src), jnp.asarray(mask),
                        jnp.asarray(pos), p["query_embed"], jnp.asarray(tgt))
    thid, tmem = detr(t(src), t(mask), t(pos), model.decoder_query_embed.weight, t(tgt))
    close(tmem, mem)
    close(thid, hid)

    # heads on the last decoder layer, as the engine applies them
    jhid = np.asarray(hid[-1])
    close(model.class_embed(t(jhid)),
          jnp.asarray(jhid) @ p["class_embed"]["kernel"] + p["class_embed"]["bias"])
    close(model.span_embed(t(jhid)),
          jL.DetrMLP(d, 2, 3).apply({"params": p["span_embed"]}, jnp.asarray(jhid)))


@pytest.mark.parametrize("block", [2, 4, 16])
def test_similarities(pair, block):
    cfg, _, p, model = pair
    d = cfg.model.dim_input
    rng = np.random.default_rng(8)
    video = rng.standard_normal((3, d), dtype=np.float32)
    segs = rng.standard_normal((7, 4, d), dtype=np.float32)
    mask = ragged(rng, 7, 4)
    music = rng.standard_normal((7, d), dtype=np.float32)
    close(tsim.dual_similarity(t(video), t(music)),
          jsim.dual_similarity(jnp.asarray(video), jnp.asarray(music)))
    xp = XPoolTransformer(d)
    ref = jsim.xpool_similarity_blocked(xp.apply, {"params": p["xpool_v2m"]},
                                        jnp.asarray(video), jnp.asarray(segs),
                                        jnp.asarray(mask), block_size=min(block, 7))
    close(tsim.xpool_similarity_blocked(model.xpool, t(video), t(segs), t(mask),
                                        block_size=min(block, 7)), ref)


def test_port_init_follows_jax_initializers(pair):
    """Seeded port init draws from the JAX package's distributions: same
    names and shapes, identity X-Pool, fixed logit_scale, and per-tensor
    spread within sampling noise of the JAX init."""
    from mgsv_tpu.interop.torch_export import export_uni_state_dict

    cfg, init, _, loaded = pair
    jax_state = export_uni_state_dict(init, cfg)
    port = MaDe(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert set(port) == set(jax_state) == set(loaded.state_dict())
    for name, ref in jax_state.items():
        ours = port[name].numpy()
        assert ours.shape == ref.shape, name
        if "pooling_cross_transformer" in name or name == "logit_scale" or ref.std() == 0:
            np.testing.assert_allclose(ours, ref, atol=1e-6, err_msg=name)
        elif ref.size >= 256:
            assert abs(ours.std() / ref.std() - 1) < 0.2, name
