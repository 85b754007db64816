"""The port's model axis (core/mesh.py at mp > 1), the sharded corpus
similarities (eval/similarity.py) and the engine's sharded index
(serve/engine.py `mesh=`), on gloo ranks on the CPU, each a plain
subprocess (tests/torch_port_dist_worker.py), against one process and
against JAX's meshes on the conftest's virtual CPU devices.

A run of dp x mp ranks computes what JAX's (dp, mp) mesh computes: rank k
sits at (k // mp, k % mp), takes its dp index's rows and draws its dp
index's masks, so the mp replicas of a dp index repeat its work and keep
the same weights.  TINY widths, float32.  One launch of 4 ranks at (2, 2)
and one of 2 ranks at (2, 1) carry every case.

Tolerances.  The step: tests/test_torch_port_dist.py's (against one
process and against JAX).  The similarities: atol 1e-5, JAX's own bar
(tests/test_eval_metrics.py).  The engine: test_torch_port_serve.py's:
ids identical, scores 1e-4, moments 1e-3 s.  cli.train: test (g) of
tests/test_torch_port_dist.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.core.mesh import make_mesh as jax_make_mesh
from mgsv_tpu.eval import similarity as jsim
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.models.xpool import XPoolTransformer as JaxXPool
from mgsv_tpu.serve import engine as jengine
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import check_mesh_shape
from mgsv_tpu_torch.core.mesh import Mesh, fold_axis_into_seed
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve import engine as tengine
from test_torch_port_dist import (BASE, CLI_TINY, EVAL, N_EVAL_ROWS, N_TRACKS, N_VIDEOS,
                                  assert_ranks_identical, assert_step_equals_jax_mesh,
                                  global_batch, ragged, run_cli, save_batches, tagged)
from test_torch_port_eval import _xpool_pair
from test_torch_port_train import TINY, _jax_params

SIM_V, SIM_M, SHARDED_M, SIM_D = 10, 21, 20, 32
ENGINE = {"data.max_v_frames": 8, "data.stride": 30.0, "data.filter_sec": 30.0,
          "data.vit_dim": 32, "data.ast_dim": 48, "model.dim_input": 16,
          "model.temporal_mlp_dim": 32, "model.detr_ffn_dim": 32,
          "model.detr_enc_layers": 1, "model.detr_dec_layers": 2,
          "model.temporal_heads": 4, "model.detr_heads": 4, "model.contrastive_dim": 16,
          "model.video_pe_len": 16, "model.audio_pe_len": 16,
          "model.compute_dtype": "float32"}
# 13 tracks: 2 shards of 7, the last padded; query 0's top 4 (top_k 3 runs
# at its bucket, 4) lie in shard 0
N_MUSIC, N_QUERY = 13, 3
QUERIES = [([0], 3), ([0, 1, 2], 5), ([0, 1, 2], N_MUSIC)]


def sim_inputs(path: str) -> str:
    rng = np.random.default_rng(7)
    s = 6
    arrays = {}
    for name, m in (("mesh", SIM_M), ("sharded", SHARDED_M)):
        arrays[f"{name}_video"] = rng.standard_normal((SIM_V, SIM_D), dtype=np.float32)
        arrays[f"{name}_tokens"] = rng.standard_normal((m, s, SIM_D), dtype=np.float32)
        arrays[f"{name}_mask"] = ragged(rng, m, s, 1)
    np.savez(path, **arrays)
    return path


def engine_world(tmp) -> dict:
    """JAX's model off its init, the port's twin, the features with query
    0's top 4 tracks moved to the front of the index, both indexes."""
    cfg, jcfg = Config.from_overrides(ENGINE), JaxConfig.from_overrides(ENGINE)
    data = cfg.data
    f, s = data.max_v_frames, data.max_snippet_num
    rng = np.random.default_rng(0)
    jmodel = JaxMaDe(jcfg)
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, f, data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, data.ast_dim)), jnp.ones((1, s)))
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), init)
    feats = rng.standard_normal((N_MUSIC, s, data.ast_dim), dtype=np.float32)
    masks = ragged(rng, N_MUSIC, s, 1)
    frames = rng.standard_normal((N_QUERY, f, data.vit_dim), dtype=np.float32)
    fmask = ragged(rng, N_QUERY, f, 2)
    model = load_jax_params(MaDe(cfg), params, cfg).eval()
    ids = [f"m{i}" for i in range(N_MUSIC)]
    first = tengine.RetrievalEngine(model, cfg, tengine.build_music_index(
        model, ids, feats, masks), sim_block_size=4).query(frames[:1], fmask[:1], top_k=4)
    top = [ids.index(m) for m in first[0]["music_ids"]]
    perm = top + [i for i in range(N_MUSIC) if i not in top]
    feats, masks, ids = feats[perm], masks[perm], [ids[i] for i in perm]
    tindex = tengine.build_music_index(model, ids, feats, masks, batch_size=5)
    jindex = jengine.build_music_index(jmodel, params, jcfg, ids, feats, masks, batch_size=5)
    weights, index, queries = (os.path.join(tmp, n) for n in ("engine.pt", "index.npz",
                                                             "queries.npz"))
    torch.save(model.state_dict(), weights)
    tindex.save(index)
    np.savez(queries, frames=frames, fmask=fmask)
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, params=params, jindex=jindex,
                frames=frames, fmask=fmask, case={
                    "kind": "engine", "overrides": ENGINE, "weights": weights,
                    "index": index, "queries": queries, "queries_list": QUERIES})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 4-rank (2, 2) job and a 2-rank (2, 1) job over every case:
    {"cases", "ranks4", "ranks2", "jax", "engine", "xpool"}."""
    tmp = tmp_path_factory.mktemp("model_axis")
    cfg = Config.from_overrides(BASE)
    batch = global_batch(cfg, 0)
    jcfg = JaxConfig.from_overrides(BASE)
    params = jax.device_get(_jax_params(jcfg, batch))
    weights = str(tmp / "base.pt")
    torch.save(load_jax_params(MaDe(cfg), params, cfg).state_dict(), weights)
    base = {"kind": "step", "overrides": BASE, "weights": weights,
            "batches": save_batches(str(tmp / "base.npz"), [batch])}
    cases = {"base": base,
             "accum": {**base, "overrides": {**BASE, "train.gradient_accumulation_steps": 2},
                       "batches": save_batches(str(tmp / "accum.npz"),
                                               [global_batch(cfg, s) for s in (1, 2)])},
             "dropout": {**base, "kind": "dropout",
                         "overrides": {**TINY, "train.scheduler": "constant"}}}

    ecfg = Config.from_overrides(EVAL)
    data_root = str(tmp / "data")
    synthetic.generate(data_root, n_rows=N_EVAL_ROWS, n_unique_music=9, data_cfg=ecfg.data,
                       seed=0)
    eweights = str(tmp / "eval.pt")
    torch.save(MaDe(ecfg, torch.Generator().manual_seed(5)).state_dict(), eweights)
    rng = np.random.default_rng(0)
    d, s = ecfg.model.dim_input, ecfg.data.max_snippet_num
    corpus = str(tmp / "corpus.npz")
    np.savez(corpus, video=rng.standard_normal((N_VIDEOS, d), dtype=np.float32),
             tokens=rng.standard_normal((N_TRACKS, s, d), dtype=np.float32),
             mask=ragged(rng, N_TRACKS, s, 1))
    for resident in (False, True):
        cases["evaluate_resident" if resident else "evaluate"] = {
            "kind": "evaluate", "overrides": EVAL, "weights": eweights, "data": data_root,
            "sim_inputs": corpus, "resident": resident}

    xparams, xmodule = _xpool_pair(SIM_D, seed=11)
    xweights = str(tmp / "xpool.pt")
    torch.save(xmodule.state_dict(), xweights)
    cases["similarity"] = {"kind": "similarity", "weights": xweights,
                           "inputs": sim_inputs(str(tmp / "sim.npz"))}
    engine = engine_world(str(tmp))
    cases["engine"] = {**engine["case"], "axis": "mp"}
    two = {"similarity": cases["similarity"], "engine": {**engine["case"], "axis": "dp"}}
    os.makedirs(tmp / "four")
    os.makedirs(tmp / "two")
    return {"cases": cases, "jax": {"jcfg": jcfg, "params": params, "batch": batch},
            "engine": engine, "xpool": xparams,
            "ranks4": W.launch(cases, str(tmp / "four"), 4, mesh_shape=(2, 2)),
            "ranks2": W.launch(two, str(tmp / "two"), 2, mesh_shape=(2, 1))}


def one_process(runs, name: str) -> dict:
    return W.run_case(runs["cases"][name], None)


def test_mesh_shapes_and_placement():
    """check_mesh_shape takes (dp, mp) with dp x mp = world, dp -1 as world /
    mp; a mesh places rank k at (k // mp, k % mp), as JAX's reshape."""
    assert check_mesh_shape((2, 2), 4) == (2, 2)
    assert check_mesh_shape((-1, 2), 4) == (2, 2)
    assert check_mesh_shape((1, 1), 4) == (4, 1)
    assert [(Mesh(dp=2, rank=k, mp=2).dp_index, Mesh(dp=2, rank=k, mp=2).mp_index)
            for k in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    devices = jax_make_mesh((2, 2), jax.devices()[:4]).devices
    assert [d.id for d in devices.reshape(-1)] == [d.id for d in jax.devices()[:4]]


def test_similarities_equal_jax_meshes(runs):
    """(a) xpool_similarity_mesh on 4 ranks at (2, 2), V=10 and M=21
    (neither divides), against JAX's on its (2, 2) mesh and the one-process
    blocked path; on 2 ranks (1-D) the same, and xpool_similarity_sharded
    at M=20 against JAX's on a dp=2 mesh: atol 1e-5 on every rank."""
    z = np.load(runs["cases"]["similarity"]["inputs"])
    apply, params = JaxXPool(SIM_D).apply, runs["xpool"]
    want = {}
    for shape in ((2, 2), (2, 1)):
        mesh = jax_make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
        want[shape] = np.asarray(jsim.xpool_similarity_mesh(
            apply, params, *(jnp.asarray(z[f"mesh_{k}"]) for k in ("video", "tokens", "mask")),
            mesh, block_size=4))
    sharded = np.asarray(jsim.xpool_similarity_sharded(
        apply, params, *(jnp.asarray(z[f"sharded_{k}"]) for k in ("video", "tokens", "mask")),
        jax_make_mesh((2, 1), jax.devices()[:2]), axis="dp", block_size=4))
    alone = one_process(runs, "similarity")
    assert want[(2, 2)].shape == (SIM_V, SIM_M)
    for shape, ranks in (((2, 2), runs["ranks4"]["similarity"]),
                         ((2, 1), runs["ranks2"]["similarity"])):
        for got in ranks:
            assert got["mesh"].shape == (SIM_V, SIM_M)
            np.testing.assert_allclose(got["mesh"], want[shape], atol=1e-5, rtol=0)
            np.testing.assert_allclose(got["mesh"], alone["mesh"], atol=1e-5, rtol=0)
    for got in runs["ranks2"]["similarity"]:
        assert got["sharded"].shape == (SIM_V, SHARDED_M)
        np.testing.assert_allclose(got["sharded"], sharded, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["sharded"], alone["sharded"], atol=1e-5, rtol=0)


def test_2x2_step_equals_one_process_and_jax_mesh(runs):
    """(b) One step at dropout 0 on 4 ranks at (2, 2) equals the one-process
    step on the global batch and JAX's step on its (2, 2) mesh, with the 4
    ranks' logs, gradients and weights bit-identical; two micro-batches an
    update (k = 2) equal one process too."""
    ranks = runs["ranks4"]["base"]
    assert_ranks_identical(ranks, ("param/", "grad/", "log"))
    W.assert_close_to_one_process(ranks[0], one_process(runs, "base"),
                                  Config.from_overrides(BASE))
    assert_step_equals_jax_mesh(runs["jax"], ranks[0], BASE, (2, 2))
    ranks = runs["ranks4"]["accum"]
    assert_ranks_identical(ranks, ("param/", "mu/", "nu/"))
    cfg = Config.from_overrides(runs["cases"]["accum"]["overrides"])
    want = {k: v for k, v in one_process(runs, "accum").items() if not k.startswith("grad/")}
    W.assert_close_to_one_process({k: v for k, v in ranks[0].items()
                                   if not k.startswith("grad/")}, want, cfg)


def test_2x2_dropout_masks_follow_the_dp_index(runs):
    """(b) At the configured rates the mp replicas of a dp index draw the
    same masks and seeds, the two dp indices differ, and all 4 ranks end
    the step with bit-identical weights."""
    r = runs["ranks4"]["dropout"]
    assert_ranks_identical(r)
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(r[a]["first_mask"], r[b]["first_mask"])
        np.testing.assert_array_equal(r[a]["seeds"], r[b]["seeds"])
    assert not np.array_equal(r[0]["first_mask"], r[2]["first_mask"])
    assert not set(r[0]["seeds"].tolist()) & set(r[2]["seeds"].tolist())
    assert fold_axis_into_seed(7, Mesh(dp=2, rank=3, mp=2).dp_index) == 7 + 1000003


@pytest.mark.parametrize("name", ["evaluate", "evaluate_resident"])
def test_2x2_evaluate_equals_one_process(runs, name):
    """(c) evaluate over (2, 2), host and resident (the plain similarity
    2-D over dp x mp, the evaluation kernel's tracks split over dp): the
    ranks, R1 and IoUs of one process on every rank."""
    want = one_process(runs, name)
    ranks = runs["ranks4"][name]
    for got in ranks:
        np.testing.assert_array_equal(got["ranks"], want["ranks"])
        assert got["metric/R1"] == want["metric/R1"]
        np.testing.assert_allclose(got["ious"], want["ious"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["sim"], want["sim"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["corpus_sim"], want["corpus_sim"], atol=1e-6, rtol=0)
    for key in ranks[0]:
        for got in ranks[1:]:
            assert np.array_equal(ranks[0][key], got[key]), key


def jax_engine_results(runs, shape, axis) -> list:
    e = runs["engine"]
    mesh = jax_make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
    eng = jengine.RetrievalEngine(e["jmodel"], e["params"], e["jcfg"], e["jindex"],
                                  sim_block_size=4, mesh=mesh, mesh_axis=axis)
    return [eng.query(e["frames"][take], e["fmask"][take], top_k=k) for take, k in QUERIES]


def assert_engine_close(got: dict, i: int, want: dict) -> None:
    np.testing.assert_array_equal(got[f"q{i}/ids"], want[f"q{i}/ids"])
    for key in ("retrieval_scores", "moment_scores"):
        np.testing.assert_allclose(got[f"q{i}/{key}"], want[f"q{i}/{key}"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[f"q{i}/moments"], want[f"q{i}/moments"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("world,shape,axis", [(2, (2, 1), "dp"), (4, (2, 2), "mp")])
def test_sharded_engine_equals_jax_and_one_process(runs, world, shape, axis):
    """(d) The engine with 13 tracks sharded over 2 ranks of `axis` (7 a
    rank, one pad track) against JAX's sharded engine on the same mesh and
    the port's one-process engine: ids identical, scores within 1e-4,
    moments within 1e-3 s, on every rank.  Query 0's candidates all lie on
    the first shard, so the other rank localizes nothing; top_k 13 is the
    real track count, and no pad track ranks."""
    ranks = runs[f"ranks{world}"]["engine"]
    alone = one_process(runs, "engine")
    row_of = {m: i for i, m in enumerate(runs["engine"]["jindex"].music_ids)}
    for i, res in enumerate(jax_engine_results(runs, shape, axis)):
        want = {f"q{i}/ids": np.asarray([[row_of[m] for m in r["music_ids"]] for r in res])}
        want.update({f"q{i}/{k}": np.asarray([r[k] for r in res]) for k in (
            "retrieval_scores", "moments", "moment_scores")})
        for got in ranks:
            assert_engine_close(got, i, want)
            assert_engine_close(got, i, alone)
    assert ranks[0]["q2/ids"].shape == (3, N_MUSIC)
    assert sorted(ranks[0]["q2/ids"][0].tolist()) == list(range(N_MUSIC))
    first = [Mesh(dp=shape[0], rank=k, mp=shape[1]).index(axis) == 0 for k in range(world)]
    assert [int(r["q0/localized_rows"]) for r in ranks] == [4 if f else 0 for f in first]
    # query 1: 3 rows at their bucket 4, top_k 5 at its bucket 8, once per axis group
    assert sum(int(r["q1/localized_rows"]) for r in ranks) == 4 * 8 * world // 2


def test_cli_train_on_a_2x2_mesh(tmp_path):
    """(e) cli.train --train.mesh_shape '[2,2]' on 4 ranks: the MP_RESULT
    lines equal across ranks, and the records equal a one-process run's
    (losses 1e-4 relative, evaluation metrics 1e-4)."""
    multi, single = str(tmp_path / "multi"), str(tmp_path / "single")
    outs = run_cli("mgsv_tpu_torch.cli.train",
                   CLI_TINY + ["--train.output_dir", multi, "--train.mesh_shape", "[2,2]"], 4)
    alone = run_cli("mgsv_tpu_torch.cli.train", CLI_TINY + ["--train.output_dir", single], 1)
    digests = tagged(outs, "MP_RESULT")
    assert [d.pop("process") for d in digests] == [0, 1, 2, 3]
    assert all(d == digests[0] for d in digests)
    with open(os.path.join(multi, "made", "history.json")) as f:
        got = json.load(f)
    with open(os.path.join(single, "made", "history.json")) as f:
        want = json.load(f)
    assert len(got) == len(want) == 2 and len(alone) == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train"]["loss"], w["train"]["loss"], rtol=1e-4)
        for k in g["eval"]:
            if k != "loss":
                np.testing.assert_allclose(g["eval"][k], w["eval"][k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)
