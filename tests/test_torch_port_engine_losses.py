"""The serving engine and `vmr_loss`: the port's engine ranks by the dual
similarity plus the video-guided music X-Pool's pooled similarity, which is
the evaluation's ranking (eval/evaluator.py::corpus_similarity) under
dual_single_loss_fuse and dual_single_sim_fuse only.  It serves those two
with corpus_similarity's scores and raises for every other vmr_loss.  JAX's
engine ranks every vmr_loss that way (mgsv_tpu/serve/engine.py:297-304), so
under "dual" and "single" its scores are not JAX's corpus similarity.

Widths of tests/test_torch_port_serve.py::small_cfg, float32, a seeded init
moved off its identity X-Pool, 12 tracks, 3 queries, top-3.  Scores 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config, DataConfig, ModelConfig
from mgsv_tpu.eval.evaluator import corpus_similarity as jax_corpus_similarity
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu_torch.eval.evaluator import corpus_similarity
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve import engine as tengine

N_MUSIC, N_VIDEO, TOP_K = 12, 3, 3
SERVED = ["dual_single_loss_fuse", "dual_single_sim_fuse"]
REFUSED = ["dual", "single", "dual_single_feature_fuse", "dual_single_oneloss"]


def small_cfg(vmr_loss: str) -> Config:
    data = DataConfig(max_v_frames=8, stride=30.0, filter_sec=30.0, vit_dim=32, ast_dim=48)
    model = ModelConfig(dim_input=16, temporal_mlp_dim=32, detr_ffn_dim=32,
                        detr_enc_layers=1, detr_dec_layers=2, temporal_heads=4,
                        detr_heads=4, contrastive_dim=16, video_pe_len=16,
                        audio_pe_len=16, compute_dtype="float32",
                        fused_detr_encoder=False, fused_xpool_sim=False)
    cfg = dataclasses.replace(Config(), data=data, model=model)
    return dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, vmr_loss=vmr_loss))


def ragged(rng, rows, length, lo):
    return (np.arange(length)[None] < rng.integers(lo, length + 1, rows)[:, None]
            ).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    cfg = small_cfg(SERVED[0])
    data = cfg.data
    f, s = data.max_v_frames, data.max_snippet_num
    rng = np.random.default_rng(0)
    jmodel = JaxMaDe(cfg)
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, f, data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, data.ast_dim)), jnp.ones((1, s)))
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), init)
    seg_feats = rng.standard_normal((N_MUSIC, s, data.ast_dim), dtype=np.float32)
    seg_masks = ragged(rng, N_MUSIC, s, 1)
    frames = rng.standard_normal((N_VIDEO, f, data.vit_dim), dtype=np.float32)
    fmask = ragged(rng, N_VIDEO, f, 2)
    ids = [f"m{i}" for i in range(N_MUSIC)]
    model = load_jax_params(MaDe(cfg), params, cfg).eval()
    index = tengine.build_music_index(model, ids, seg_feats, seg_masks, batch_size=5)
    jindex = jengine.build_music_index(jmodel, params, cfg, ids, seg_feats, seg_masks,
                                       batch_size=5)
    with torch.no_grad():
        _, video_emb, _ = model.video_tower(torch.from_numpy(frames), torch.from_numpy(fmask),
                                            plain_temporal=True)
    return dict(params=params, model=model, index=index, jindex=jindex, frames=frames,
                fmask=fmask, video_emb=video_emb.numpy())


def corpus_sim(world, cfg) -> np.ndarray:
    """The port's evaluation similarity [N_VIDEO, N_MUSIC] of the queries
    against the index, for `cfg`'s vmr_loss."""
    ix = world["index"]
    return corpus_similarity(world["model"], torch.from_numpy(world["video_emb"]),
                             *map(torch.from_numpy, (ix.music_embs, ix.seg_tokens,
                                                     ix.seg_masks)), cfg).numpy()


def scores_against(results, sim: np.ndarray, ids) -> float:
    """Largest gap between each result's retrieval score and `sim` at its
    track."""
    col = {m: j for j, m in enumerate(ids)}
    return max(abs(score - sim[i, col[m]])
               for i, r in enumerate(results)
               for m, score in zip(r["music_ids"], r["retrieval_scores"]))


@pytest.mark.parametrize("vmr_loss", SERVED)
def test_engine_scores_are_the_evaluation_similarity(world, vmr_loss):
    """The served losses: the engine's top-k are the evaluation
    similarity's top-k, with its scores."""
    cfg = small_cfg(vmr_loss)
    got = tengine.RetrievalEngine(world["model"], cfg, world["index"], sim_block_size=4,
                                  use_fused_kernels=False).query(
        world["frames"], world["fmask"], top_k=TOP_K)
    sim = corpus_sim(world, cfg)
    ids = world["index"].music_ids
    for i, r in enumerate(got):
        assert r["music_ids"] == [ids[j] for j in np.argsort(-sim[i], kind="stable")[:TOP_K]]
    assert scores_against(got, sim, ids) <= 1e-4


@pytest.mark.parametrize("vmr_loss", REFUSED)
def test_engine_refuses_other_losses(world, vmr_loss):
    with pytest.raises(ValueError, match=f"vmr_loss={vmr_loss!r}"):
        tengine.RetrievalEngine(world["model"], small_cfg(vmr_loss), world["index"])


@pytest.mark.parametrize("vmr_loss", ["dual", "single"] + SERVED)
def test_jax_engine_ranks_every_loss_one_way(world, vmr_loss):
    """JAX's engine scores equal JAX's corpus similarity for the served
    losses, and are off it by more than 0.05 under "dual" and "single"
    (the port's engine refuses those)."""
    jcfg = small_cfg(vmr_loss)
    results = jengine.RetrievalEngine(JaxMaDe(jcfg), world["params"], jcfg, world["jindex"],
                                      sim_block_size=4, use_fused_kernels=False).query(
        world["frames"], world["fmask"], top_k=TOP_K)
    ix = world["jindex"]
    sim = np.asarray(jax_corpus_similarity(world["params"], world["video_emb"], ix.music_embs,
                                           ix.seg_tokens, ix.seg_masks, jcfg))
    gap = scores_against(results, sim, ix.music_ids)
    if vmr_loss in SERVED:
        assert gap <= 1e-4
    else:
        assert gap > 0.05
