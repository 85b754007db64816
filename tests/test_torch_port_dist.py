"""The port's data parallelism (core/{dist,mesh}.py and every layer that
takes a mesh) on 2 gloo ranks on the CPU, each a plain subprocess
(tests/torch_port_dist_worker.py), against one process and against JAX's
dp=2 mesh.

A run of N ranks computes what JAX's dp=N mesh computes: one step on the
global batch, each rank on its rows.  Tiny widths (TINY of
tests/test_torch_port_train.py), float32, a global batch of 8 rows (4 a
rank) whose music codes repeat across the ranks.

Tolerances.  Against one process (the same code with mesh None): the loss
and every log within 1e-5 relative; each gradient, Adam moment and running
buffer within 1e-5 of its tensor's largest element plus 1e-7 of the
model's largest gradient element (the attention biases' gradients, which
softmax cancels, are rounding noise, and the EmbeddingNet BatchNorm
scales' are sums of B x D terms that cancel to 1e-6 of their size; the
ranks' BatchNorm runs on the gathered moments, one process's through
F.batch_norm); the weights after the update within float32 rounding, or 2
lr where a gradient lies within that tolerance of zero (Adam's first
update is lr * sign(g)).  Against JAX: test_torch_port_train.py's tolerances.  Each
rank's weights equal every other's bit for bit.
"""

import glob
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.core.mesh import make_mesh as jax_make_mesh, shard_batch
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mgsv_tpu.train.step import create_state, make_train_step as jax_make_train_step
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.device import check_mesh_shape
from mgsv_tpu_torch.core.mesh import Mesh, fold_axis_into_seed, process_local_rows
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import example_batch
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.serve import engine as tengine
from test_torch_port_train import NO_DROPOUT, TINY, _assert_update, _jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BATCH = 8
CODES = np.array([0, 1, 0, 2, 1, 3, 3, 0], np.int32)     # tracks repeat across ranks
BASE = {**TINY, **NO_DROPOUT, "train.scheduler": "constant", "loss.ignore_same_music": 0}
STEP_CONFIGS = {
    "base": {},
    "mlp": {"model.agg_module": "mlp"},
    "xa_both_xpool_query": {"model.vmr_fusion": "XA-music-video", "loss.vmr_loss": "single",
                            "model.moment_query_type": "xpool"},
    "oneloss_regression": {"model.vmr_fusion": "XA-music-video",
                           "loss.vmr_loss": "dual_single_oneloss",
                           "model.mml_localization": "regression"},
    "feature_fuse_ca": {"loss.vmr_loss": "dual_single_feature_fuse", "model.mml_fusion": "CA",
                        "model.ca_dropout": 0.0},
}
EVAL = {**TINY, "train.batch_size_val": 5, "train.batch_size_train": 8}
N_EVAL_ROWS, N_TRACKS, N_VIDEOS = 21, 7, 5
CLI_TINY = [
    "--synthetic", "32",
    "--data.max_v_frames", "6", "--data.stride", "40.0", "--data.filter_sec", "40.0",
    "--data.vit_dim", "24", "--data.ast_dim", "32",
    "--model.dim_input", "16", "--model.temporal_mlp_dim", "32",
    "--model.detr_ffn_dim", "32", "--model.detr_enc_layers", "1",
    "--model.detr_dec_layers", "2", "--model.temporal_heads", "2",
    "--model.detr_heads", "2", "--model.contrastive_dim", "16",
    "--model.video_pe_len", "8", "--model.audio_pe_len", "8",
    "--model.compute_dtype", "float32",
    "--train.epochs", "2", "--train.batch_size_train", "16",
    "--train.batch_size_val", "16", "--device", "cpu",
    # two ranks cannot draw one process's masks: the records compare at dropout 0
    "--model.temporal_dropout", "0.0", "--model.xpool_dropout", "0.0",
    "--model.detr_dropout", "0.0",
]


def save_batches(path: str, batches: list) -> str:
    np.savez(path, **{f"{k}/{i}": v for i, b in enumerate(batches) for k, v in b.items()})
    return path


def global_batch(cfg: Config, seed: int) -> dict:
    batch = example_batch(np.random.RandomState(seed), cfg, BATCH)
    batch["music_codes"] = CODES
    return batch


def ragged(rng, rows, length, lo):
    return (np.arange(length)[None] < rng.integers(lo, length + 1, rows)[:, None]
            ).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank job over every case; {"cases", "ranks": {case: [npz of each
    rank]}, "jax": the base config's JAX params and batch}."""
    tmp = tmp_path_factory.mktemp("dist")
    cases, jax_side = {}, {}
    for name, extra in STEP_CONFIGS.items():
        over = {**BASE, **extra}
        cfg = Config.from_overrides(over)
        batch = global_batch(cfg, 0)
        if name == "base":             # JAX's init, carried across (test (b))
            jcfg = JaxConfig.from_overrides(over)
            params = jax.device_get(_jax_params(jcfg, batch))
            model = load_jax_params(MaDe(cfg), params, cfg)
            jax_side = {"jcfg": jcfg, "params": params, "batch": batch}
        else:
            model = MaDe(cfg, torch.Generator().manual_seed(3))
        weights = str(tmp / f"{name}.pt")
        torch.save(model.state_dict(), weights)
        cases[name] = {"kind": "step", "overrides": over, "weights": weights,
                       "batches": save_batches(str(tmp / f"{name}.npz"), [batch])}
    base = cases["base"]
    cases["accum"] = {**base, "overrides": {**BASE, "train.gradient_accumulation_steps": 2},
                      "batches": save_batches(str(tmp / "accum.npz"),
                                              [global_batch(Config.from_overrides(BASE), s)
                                               for s in (1, 2)])}
    drop_over = {**TINY, "train.scheduler": "constant"}
    cases["dropout"] = {**base, "kind": "dropout", "overrides": drop_over}

    ecfg = Config.from_overrides(EVAL)
    data_root = str(tmp / "data")
    synthetic.generate(data_root, n_rows=N_EVAL_ROWS, n_unique_music=9, data_cfg=ecfg.data,
                       seed=0)
    eweights = str(tmp / "eval.pt")
    torch.save(MaDe(ecfg, torch.Generator().manual_seed(5)).state_dict(), eweights)
    rng = np.random.default_rng(0)
    d, s = ecfg.model.dim_input, ecfg.data.max_snippet_num
    sim_inputs = str(tmp / "sim_inputs.npz")
    np.savez(sim_inputs, video=rng.standard_normal((N_VIDEOS, d), dtype=np.float32),
             tokens=rng.standard_normal((N_TRACKS, s, d), dtype=np.float32),
             mask=ragged(rng, N_TRACKS, s, 1))
    for resident in (False, True):
        cases["evaluate_resident" if resident else "evaluate"] = {
            "kind": "evaluate", "overrides": EVAL, "weights": eweights, "data": data_root,
            "sim_inputs": sim_inputs, "resident": resident}
    cases["resident"] = {"kind": "resident", "overrides": EVAL, "data": data_root}

    return {"cases": cases, "ranks": W.launch(cases, str(tmp), WORLD), "jax": jax_side}


def one_process(runs, name: str) -> dict:
    return W.run_case(runs["cases"][name], None)


def assert_ranks_identical(ranks: list, prefixes=("param/",)) -> None:
    for key in ranks[0]:
        if key.startswith(prefixes):
            for r in ranks[1:]:
                assert np.array_equal(ranks[0][key], r[key]), f"ranks differ: {key}"


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_two_rank_step_equals_one_process(runs, name):
    """(a) One step at dropout 0 on 2 ranks equals the one-process step on
    the global batch: the global loss and logs, every synchronized gradient,
    the Adam moments, the running buffers (the "mlp" aggregator's batch
    statistics span the ranks) and the updated weights, identical on both
    ranks.  loss.ignore_same_music 0: codes 0 and 3 repeat across ranks."""
    ranks = runs["ranks"][name]
    assert_ranks_identical(ranks, ("param/", "grad/", "buffer/", "log"))
    want = one_process(runs, name)
    cfg = Config.from_overrides(runs["cases"][name]["overrides"])
    W.assert_close_to_one_process(ranks[0], want, cfg)
    if name == "mlp":
        assert any(k.startswith("buffer/") for k in want)


def test_two_rank_step_equals_jax_dp2_mesh(runs):
    """(b) The same step equals JAX's on a dp=2 mesh (its kernels under
    shard_map, Pallas in interpret mode), the weights carried across from
    JAX's init: test_torch_port_train.py's tolerances (loss 1e-5, gradients
    atol 1e-5 + rtol 1e-4, the update through _assert_update)."""
    assert_step_equals_jax_mesh(runs["jax"], runs["ranks"]["base"][0],
                                runs["cases"]["base"]["overrides"], (2, 1))


def assert_step_equals_jax_mesh(side: dict, got: dict, overrides: dict, shape) -> None:
    """A rank's step results `got` against JAX's step on a mesh of `shape`
    from the same init and global batch (`side`), at test (b)'s
    tolerances."""
    jcfg, params, batch = side["jcfg"], side["params"], side["batch"]
    mesh = jax_make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
    model = JaxMaDe(jcfg, mesh=mesh)
    jb = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = model.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                          jb["segment_mask"], v_duration=jb["v_duration"],
                          deterministic=False, rngs={"dropout": key})
        return jax_total_loss(out, jb["spans_target"], jcfg, music_codes=jb["music_codes"])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_make_optimizer(jcfg, W.HORIZON)
    state = create_state(model, jcfg, tx, jax.random.PRNGKey(0), jb)
    state = state.replace(params=params, opt_state=tx.init(params))
    state, _ = jax_make_train_step(model, jcfg)(state, jb, key)
    after = jax.device_get(state.params)

    cfg = Config.from_overrides(overrides)
    np.testing.assert_allclose(float(got["log0/loss"]), float(loss), rtol=1e-5)
    want = jax_tree_to_state_dict(jax.device_get(grads), cfg)
    for name, g in want.items():
        np.testing.assert_allclose(got.get(f"grad/{name}", np.zeros_like(g)), g, atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    model_t = load_jax_params(MaDe(cfg), params, cfg)
    with torch.no_grad():
        for name, p in model_t.named_parameters():
            p.copy_(torch.from_numpy(got[f"param/{name}"]))
    _assert_update(model_t, params, after, grads, cfg, cfg.train.matching_lr,
                   grad_atol=1e-5, grad_rtol=1e-4)


def test_dropout_masks_differ_by_rank_and_weights_stay_identical(runs):
    """(c) At the configured dropout rates both ranks end the step with
    bit-identical weights, while rank 0's masks differ from rank 1's at the
    same local rows: the first plain dropout mask and every kernel seed."""
    r0, r1 = runs["ranks"]["dropout"]
    assert_ranks_identical([r0, r1])
    assert all(np.isfinite(v).all() for k, v in r0.items() if k.startswith("param/"))
    assert r0["first_mask"].shape == r1["first_mask"].shape
    assert 0.05 < r0["first_mask"].mean() < 0.95
    assert not np.array_equal(r0["first_mask"], r1["first_mask"])
    assert len(r0["seeds"]) == len(r1["seeds"]) > 0
    assert not set(r0["seeds"].tolist()) & set(r1["seeds"].tolist())
    # rank 0 keeps the one-process stream: its fold is the identity
    assert fold_axis_into_seed(7, 0) == 7 and fold_axis_into_seed(7, 1) == 7 + 1000003


def test_two_rank_accumulation_equals_one_process(runs):
    """(d) Two micro-batches a update on 2 ranks (one all-reduce, at the
    update) equal one process: both micro-steps' logs, the moments and the
    weights after the update."""
    ranks = runs["ranks"]["accum"]
    assert_ranks_identical(ranks, ("param/", "mu/", "nu/"))
    cfg = Config.from_overrides(runs["cases"]["accum"]["overrides"])
    want = one_process(runs, "accum")
    got = {k: v for k, v in ranks[0].items() if not k.startswith("grad/")}
    W.assert_close_to_one_process(got, {k: v for k, v in want.items()
                                      if not k.startswith("grad/")}, cfg)
    assert "log1/loss" in got and "log0/grad_norm" not in got


@pytest.mark.parametrize("name", ["evaluate", "evaluate_resident"])
def test_two_rank_evaluate_equals_one_process(runs, name):
    """(e) evaluate on 2 ranks (batch 5 padded to 6, a padded last batch):
    the same ranks, IoUs and spans as one process on every rank, and the
    corpus similarity of 7 tracks split over the ranks on the evaluation
    kernel within 1e-6 of the whole one."""
    ranks = runs["ranks"][name]
    want = one_process(runs, name)
    for got in ranks:
        np.testing.assert_array_equal(got["ranks"], want["ranks"])
        np.testing.assert_allclose(got["ious"], want["ious"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["pred_spans"], want["pred_spans"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["sim"], want["sim"], atol=1e-6, rtol=0)
        assert got["corpus_sim"].shape == (N_VIDEOS, N_TRACKS)
        np.testing.assert_allclose(got["corpus_sim"], want["corpus_sim"], atol=1e-6, rtol=0)
    for key in ranks[0]:
        assert np.array_equal(ranks[0][key], ranks[1][key]), key


def test_sharded_residency_batches_equal_host_pipeline(runs):
    """(f) The dp-sharded resident tables give each rank the batches the
    host pipeline gives it, torch.equal, and those are the rank's rows of
    the one-process batches (music codes coded over the global batch)."""
    whole = one_process(runs, "resident")
    per = BATCH // WORLD
    for r, got in enumerate(runs["ranks"]["resident"]):
        keys = [k for k in got if k.startswith("resident")]
        assert keys and len(keys) == len([k for k in got if k.startswith("host")])
        for key in keys:
            host = "host" + key[len("resident"):]
            if key.endswith("meta_ids"):      # the global batch's, on every rank
                np.testing.assert_array_equal(got[key], got[host])
                np.testing.assert_array_equal(got[key], whole[key])
            else:
                assert torch.equal(torch.from_numpy(got[key]), torch.from_numpy(got[host])), key
                np.testing.assert_array_equal(got[key], whole[key][r * per:(r + 1) * per])


def run_cli(module: str, args: list, ranks: int) -> list:
    """Run a CLI on `ranks` ranks (1: no coordinator); stdout of each."""
    port = W.free_port()
    extra = (lambda r: ["--coordinator", f"localhost:{port}", "--num-processes", str(ranks),
                        "--process-id", str(r)]) if ranks > 1 else (lambda r: [])
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-m", module, *args, *extra(r)], cwd=REPO,
                              env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(ranks)]
    return [out for out, _ in W.wait_all(procs, module)]


def tagged(outs: list, tag: str) -> list:
    return [json.loads(re.search(rf"^{tag} (.*)$", o, re.M).group(1)) for o in outs]


def test_cli_train_and_evaluate_on_two_ranks(tmp_path):
    """(g) cli.train --coordinator on 2 ranks: the MP_RESULT lines equal
    across ranks, one checkpoint tree, and records equal to a one-process
    run (losses 1e-4 relative after two epochs); cli.evaluate on 2 ranks
    prints the same metrics on both ranks, equal to one process's."""
    multi, single = str(tmp_path / "multi"), str(tmp_path / "single")
    outs = run_cli("mgsv_tpu_torch.cli.train", CLI_TINY + ["--train.output_dir", multi], 2)
    run_cli("mgsv_tpu_torch.cli.train", CLI_TINY + ["--train.output_dir", single], 1)
    digests = tagged(outs, "MP_RESULT")
    assert [d.pop("process") for d in digests] == [0, 1]
    assert digests[0] == digests[1]
    run = os.path.join(multi, "made")
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(multi, "**", "ckpt_*"),
                                                         recursive=True)) == sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(run, "ckpt_*")))
    assert os.path.isdir(os.path.join(run, "ckpt_last"))
    # one event stream where tensorboardX is installed, none without it
    assert len(glob.glob(os.path.join(multi, "**", "events.out.tfevents.*"),
                         recursive=True)) <= 1
    with open(os.path.join(run, "history.json")) as f:
        got = json.load(f)
    with open(os.path.join(single, "made", "history.json")) as f:
        want = json.load(f)
    assert len(got) == len(want) == 2
    assert digests[0]["losses"] == [r["train"]["loss"] for r in got]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train"]["loss"], w["train"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["train"]["miou"], w["train"]["miou"], rtol=1e-4)
        assert g["eval"].keys() == w["eval"].keys()
        for k in g["eval"]:
            if k != "loss":
                np.testing.assert_allclose(g["eval"][k], w["eval"][k], rtol=1e-4, atol=1e-6,
                                           err_msg=k)

    root = os.path.join(multi, "synthetic_data")
    args = ["--ckpt", "best_r1", "--run-dir", run, "--split", "val",
            "--data.val_csv", os.path.join(root, "data.csv"), "--data.feature_root", root,
            *CLI_TINY[2:]]
    evals = tagged(run_cli("mgsv_tpu_torch.cli.evaluate", args, 2), "EVAL_RESULT")
    alone = tagged(run_cli("mgsv_tpu_torch.cli.evaluate", args, 1), "EVAL_RESULT")[0]
    assert [e.pop("process") for e in evals] == [0, 1] and alone.pop("process") == 0
    assert evals[0] == evals[1]
    for k, v in alone["results"]["best_r1"].items():
        np.testing.assert_allclose(evals[0]["results"]["best_r1"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_model_axis_and_engine_mesh_raise():
    """(h) What stays unported raises and names its ROADMAP.md item: one
    process over several devices (a mesh shape of several ranks in one
    process, a JAX device mesh given as the mesh); a dp x mp that is not the
    world's, an mp that does not divide it and an engine axis that is not
    dp or mp are refused.  The model axis, the engine's mesh path and the
    sharded similarities are held by tests/test_torch_port_model_axis.py."""
    for shape in ((2, 1), (1, 2), (2, 2), (-1, 2)):
        with pytest.raises(NotImplementedError, match="one process over several devices"):
            check_mesh_shape(shape, 1)
    with pytest.raises(ValueError, match="dp x mp must be"):
        check_mesh_shape((3, 1), 2)
    with pytest.raises(ValueError, match="dp x mp must be"):
        check_mesh_shape((2, 2), 2)
    with pytest.raises(ValueError, match="does not divide"):
        check_mesh_shape((-1, 3), 4)
    for shape in ((2, 1), (-1, 1), (1, 1)):
        assert check_mesh_shape(shape, 2) == (2, 1)
    cfg = Config.from_overrides(TINY)
    model = MaDe(cfg)
    index = tengine.MusicIndex(["a"], np.zeros((1, 32), np.float32),
                               np.zeros((1, cfg.data.max_snippet_num, 32), np.float32),
                               np.ones((1, cfg.data.max_snippet_num), np.float32))
    with pytest.raises(NotImplementedError, match="one process over several devices"):
        tengine.RetrievalEngine(model, cfg, index, mesh=jax_make_mesh((2, 1),
                                                                       jax.devices()[:2]))
    with pytest.raises(ValueError, match="mesh_axis"):
        tengine.RetrievalEngine(model, cfg, index, mesh=Mesh(dp=2, rank=0), mesh_axis="tp")
    np.testing.assert_array_equal(process_local_rows(8, Mesh(dp=2, rank=1)), np.arange(4, 8))
    with pytest.raises(ValueError):
        process_local_rows(7, Mesh(dp=2, rank=0))
