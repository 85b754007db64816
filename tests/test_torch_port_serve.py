"""The port's serving slice vs the JAX package's: index build, engine query
(retrieval + localization), the shared index format, the index CLI through
a reference-format checkpoint, and the HTTP server.

Small widths as in tests/test_serve.py, float32 on both sides, inputs from
numpy seeds.  The JAX engine runs use_fused_kernels=False (its fused path
needs a TPU; tests/test_detr_fused.py pins the two JAX paths equal).  The
port runs both settings: on CPU tensors the kernel wrapper takes its plain
version.  Tolerances: top-k ids identical, scores 1e-4, moments 1e-3 s on
the 240 s scale (float32, summation order only).
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config, DataConfig, ModelConfig
from mgsv_tpu.data.feature_store import PackedFeatureStore
from mgsv_tpu.interop.torch_export import export_uni_state_dict, save_reference_checkpoint
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu_torch.serve.server import RetrievalServer
from mgsv_tpu_torch.cli import index as index_cli
from mgsv_tpu_torch.interop.from_jax import load_jax_params, load_reference_bin
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve import engine as tengine

N_MUSIC, N_VIDEO, TOP_K = 12, 3, 3


def small_cfg() -> Config:
    data = DataConfig(max_v_frames=8, stride=30.0, filter_sec=30.0, vit_dim=32, ast_dim=48)
    model = ModelConfig(dim_input=16, temporal_mlp_dim=32, detr_ffn_dim=32,
                        detr_enc_layers=1, detr_dec_layers=2, temporal_heads=4,
                        detr_heads=4, contrastive_dim=16, video_pe_len=16,
                        audio_pe_len=16, compute_dtype="float32",
                        fused_detr_encoder=False, fused_xpool_sim=False)
    return dataclasses.replace(Config(), data=data, model=model)


def ragged(rng, rows, length, lo):
    return (np.arange(length)[None] < rng.integers(lo, length + 1, rows)[:, None]
            ).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    cfg = small_cfg()
    data = cfg.data
    f, s = data.max_v_frames, data.max_snippet_num
    rng = np.random.default_rng(0)
    jmodel = JaxMaDe(cfg)
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, f, data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, data.ast_dim)), jnp.ones((1, s)))
    # move every parameter off its init so no weight can pass by symmetry
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), init)
    seg_feats = rng.standard_normal((N_MUSIC, s, data.ast_dim), dtype=np.float32)
    seg_masks = ragged(rng, N_MUSIC, s, 1)
    frames = rng.standard_normal((N_VIDEO, f, data.vit_dim), dtype=np.float32)
    fmask = ragged(rng, N_VIDEO, f, 2)
    ids = [f"m{i}" for i in range(N_MUSIC)]
    jindex = jengine.build_music_index(jmodel, params, cfg, ids, seg_feats, seg_masks,
                                       batch_size=5)
    model = load_jax_params(MaDe(cfg), params, cfg).eval()
    tindex = tengine.build_music_index(model, ids, seg_feats, seg_masks, batch_size=5)
    return dict(cfg=cfg, jmodel=jmodel, params=params, model=model, ids=ids,
                seg_feats=seg_feats, seg_masks=seg_masks, frames=frames, fmask=fmask,
                jindex=jindex, tindex=tindex, jax_results={})


def jax_results(world, index_dtype):
    cache = world["jax_results"]
    if index_dtype not in cache:
        eng = jengine.RetrievalEngine(world["jmodel"], world["params"], world["cfg"],
                                      world["jindex"], sim_block_size=4,
                                      use_fused_kernels=False, index_dtype=index_dtype)
        cache[index_dtype] = eng.query(world["frames"], world["fmask"], top_k=TOP_K)
    return cache[index_dtype]


def assert_same_results(ours, ref, score_atol=1e-4, span_atol=1e-3, retrieval_atol=None):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["music_ids"] == b["music_ids"]
        np.testing.assert_allclose(a["retrieval_scores"], b["retrieval_scores"],
                                   atol=retrieval_atol or score_atol, rtol=0)
        np.testing.assert_allclose(a["moment_scores"], b["moment_scores"],
                                   atol=score_atol, rtol=0)
        np.testing.assert_allclose(a["moments"], b["moments"], atol=span_atol, rtol=0)


def test_index_matches_jax(world):
    j, t = world["jindex"], world["tindex"]
    assert t.music_ids == j.music_ids
    for name in ("music_embs", "seg_tokens", "seg_masks"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_query_matches_jax(world, fused, index_dtype):
    eng = tengine.RetrievalEngine(world["model"], world["cfg"], world["tindex"],
                                  sim_block_size=4, use_fused_kernels=fused,
                                  index_dtype=index_dtype)
    assert eng.use_fused_kernels is fused
    ours = eng.query(world["frames"], world["fmask"], top_k=TOP_K)
    # Both sides round the stored index identically.  The JAX engine then
    # L2-normalizes the bfloat16 music embeddings in bfloat16 arithmetic
    # (the port promotes to float32 first): up to one bfloat16 step of the
    # normalizer, 2^-8 ~ 4e-3 relative, on a dual similarity of magnitude
    # <= 1.  Localization reads the same stored tokens on both sides and
    # keeps the float32 tolerances.
    retrieval_atol = 5e-3 if index_dtype == "bfloat16" else None
    assert_same_results(ours, jax_results(world, index_dtype),
                        retrieval_atol=retrieval_atol)


def test_engine_defaults_to_plain_path_on_cpu(world):
    eng = tengine.RetrievalEngine(world["model"], world["cfg"], world["tindex"])
    assert not eng.use_fused_kernels


def test_batch_buckets_and_top_k_clamp(world):
    eng = tengine.RetrievalEngine(world["model"], world["cfg"], world["tindex"],
                                  sim_block_size=5)
    assert [tengine._bucket(b) for b in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    batched = eng.query(world["frames"], world["fmask"], top_k=TOP_K)    # 3 -> 4
    for i in range(N_VIDEO):
        single = eng.query(world["frames"][i:i + 1], world["fmask"][i:i + 1], top_k=TOP_K)
        assert_same_results(single, batched[i:i + 1], score_atol=1e-5)
    over = eng.query(world["frames"][:1], world["fmask"][:1], top_k=50)[0]
    assert sorted(over["music_ids"]) == sorted(world["ids"])
    assert over["retrieval_scores"] == sorted(over["retrieval_scores"], reverse=True)


def test_jax_built_index_file_loads(world, tmp_path):
    path = str(tmp_path / "index.npz")
    world["jindex"].save(path)
    loaded = tengine.MusicIndex.load(path)
    assert loaded.music_ids == world["ids"]
    np.testing.assert_array_equal(loaded.seg_tokens, world["jindex"].seg_tokens)
    eng = tengine.RetrievalEngine(world["model"], world["cfg"], loaded, sim_block_size=4)
    assert_same_results(eng.query(world["frames"], world["fmask"], top_k=TOP_K),
                        jax_results(world, "float32"))


def _overrides(cfg: Config):
    """`--section.key value` flags that rebuild `cfg` from Config()."""
    base, out = Config(), []
    for section in ("data", "model"):
        ours, ref = getattr(cfg, section), getattr(base, section)
        for field in dataclasses.fields(ours):
            value = getattr(ours, field.name)
            if value != getattr(ref, field.name):
                out += [f"--{section}.{field.name}", json.dumps(value)]
    return out


def test_cli_build_and_query_through_reference_checkpoint(world, tmp_path, capsys):
    cfg = world["cfg"]
    ckpt = str(tmp_path / "made.bin")
    save_reference_checkpoint(world["params"], cfg, ckpt)
    PackedFeatureStore.build(str(tmp_path / "music"), world["ids"],
                             {"feats": world["seg_feats"], "mask": world["seg_masks"]})
    vids = [f"v{i}" for i in range(N_VIDEO)]
    PackedFeatureStore.build(str(tmp_path / "video"), vids,
                             {"feats": world["frames"], "mask": world["fmask"]})
    common = ["--ckpt", ckpt, "--device", "cpu", *_overrides(cfg)]
    index_path = str(tmp_path / "index.npz")
    index_cli.main(["build", "--music-store", str(tmp_path / "music"),
                    "--out", index_path, *common])
    assert json.loads(capsys.readouterr().out)["tracks"] == N_MUSIC
    built = tengine.MusicIndex.load(index_path)
    np.testing.assert_allclose(built.seg_tokens, world["jindex"].seg_tokens, atol=1e-5)

    index_cli.main(["query", "--index", index_path, "--video-store", str(tmp_path / "video"),
                    "--video-id", "v1", "--top-k", str(TOP_K), *common])
    reply = json.loads(capsys.readouterr().out)
    assert reply["video_id"] == "v1"
    assert_same_results([{k: v for k, v in reply.items() if k != "video_id"}],
                        jax_results(world, "float32")[1:2])


def test_http_server_matches_direct_query(world):
    eng = tengine.RetrievalEngine(world["model"], world["cfg"], world["tindex"],
                                  sim_block_size=4)
    server = RetrievalServer(eng, host="127.0.0.1", port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["index_size"] == N_MUSIC
        body = json.dumps({"frame_feats": world["frames"][:1].tolist(),
                           "frame_mask": world["fmask"][:1].tolist(), "top_k": TOP_K})
        conn.request("POST", "/query", body=body,
                     headers={"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
        assert reply["results"] == eng.query(world["frames"][:1], world["fmask"][:1],
                                             top_k=TOP_K)
    finally:
        server.stop()


@pytest.mark.parametrize("extra,loads", [("clip_model.visual.proj", True),
                                          ("ast_model.v.cls_token", True),
                                          ("stray_head.weight", False)])
def test_reference_bin_loads_strict_beside_frozen_towers(world, tmp_path, extra, loads):
    """A .bin the reference wrote carries its frozen CLIP/AST encoders too;
    those are dropped, and any other unknown entry fails the strict load."""
    cfg = world["cfg"]
    state = {k: torch.from_numpy(np.array(v))
             for k, v in export_uni_state_dict(world["params"], cfg).items()}
    state[extra] = torch.zeros(3)
    path = str(tmp_path / "ref.bin")
    torch.save({"epoch": 1, "loss": 0.0, "model_state_dict": state}, path)
    if not loads:
        with pytest.raises(RuntimeError, match="stray_head"):
            load_reference_bin(path, cfg)
        return
    model = load_reference_bin(path, cfg)
    for name, value in world["model"].state_dict().items():
        torch.testing.assert_close(model.state_dict()[name], value, rtol=0, atol=0)
