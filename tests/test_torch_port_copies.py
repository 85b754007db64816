"""The port's own copies of the JAX package's framework-free pieces agree
with the originals: the typed Config, the `--section.key` override parser,
the reference state-dict key map, the example batch, the synthetic data
generator, the CSV index, the epoch index stream, the native gather's C++
source, the best-metric tracker, the host rankings, the analytic FLOP
count, and the package's lazy exports."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__
from mgsv_tpu.cli.train import parse_kv_overrides as jax_parse
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.core import flops as jax_flops
from mgsv_tpu.core.checkpoint import BestMetricTracker as JaxBestMetricTracker
from mgsv_tpu.data import synthetic as jax_synthetic
from mgsv_tpu.data.csv_index import load_csv_index as jax_load_csv_index
from mgsv_tpu.data.dataset import epoch_index_batches as jax_epoch_index_batches
from mgsv_tpu.eval.metrics import dedup_rank as jax_dedup_rank, rect_rank as jax_rect_rank
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import flops
from mgsv_tpu_torch.core.checkpoint import BestMetricTracker
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.csv_index import load_csv_index
from mgsv_tpu_torch.data.dataset import epoch_index_batches
from mgsv_tpu_torch.data.example_batch import example_batch
from mgsv_tpu_torch.eval.metrics import dedup_rank, rect_rank
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe

OVERRIDES = [
    {},
    {"model.dim_input": 32, "model.detr_enc_layers": 1, "loss.eos_coef": 0.2,
     "train.scheduler": "constant", "data.stride": 20.0},
    {"model.compute_dtype": "float32", "model.decoder_self_attn": False,
     "model.video_temporal_depth": 2, "train.mesh_shape": [2, 1]},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_config_equals_jax_config(overrides):
    ours, ref = Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.data.max_snippet_num == ref.data.max_snippet_num
    assert (ours.loss.foreground_label, ours.loss.background_label) == (
        ref.loss.foreground_label, ref.loss.background_label)
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("bad", [{"model.nope": 1}, {"nosection": 1},
                                 {"model.span_loss_type": "ce"}])
def test_config_rejects_what_jax_rejects(bad):
    errors = []
    for cls in (Config, JaxConfig):
        with pytest.raises((KeyError, TypeError, ValueError)) as info:
            cls.from_overrides(bad)
        errors.append(type(info.value))
    assert errors[0] == errors[1]


def test_override_parser_equals_jax_parser():
    argv = ["--model.dim_input", "64", "--train.scheduler=constant", "--data.ast_dim",
            "96", "--train.name", "run-1", "--model.fusion_mask", "false"]
    assert parse_kv_overrides(argv) == jax_parse(argv)


# the variant matrix's configurations (CA, both X-Pool sides, pre-norm with
# the moment head, regression, the shared stack) at these widths
_KEY_MAP_TINY = {"model.dim_input": 16, "model.temporal_mlp_dim": 32,
                 "model.detr_ffn_dim": 32, "model.detr_enc_layers": 1,
                 "model.detr_dec_layers": 1, "model.video_pe_len": 16,
                 "model.audio_pe_len": 16, "data.vit_dim": 32, "data.ast_dim": 48,
                 "data.max_v_frames": 8, "data.stride": 30.0, "data.filter_sec": 30.0}


@pytest.mark.parametrize("overrides", [
    {"model.dim_input": 16, "model.temporal_mlp_dim": 32, "model.detr_ffn_dim": 32,
     "model.detr_enc_layers": 1, "model.detr_dec_layers": 2, "model.contrastive_dim": 16,
     "model.video_pe_len": 16, "model.audio_pe_len": 16, "data.vit_dim": 32,
     "data.ast_dim": 48, "data.max_v_frames": 8, "data.stride": 30.0,
     "data.filter_sec": 30.0},
    {"model.dim_input": 16, "model.temporal_mlp_dim": 32, "model.detr_ffn_dim": 32,
     "model.detr_enc_layers": 2, "model.detr_dec_layers": 1, "model.decoder_self_attn": False,
     "model.video_pe_len": 16, "model.audio_pe_len": 16, "data.vit_dim": 32,
     "data.ast_dim": 48, "data.max_v_frames": 8, "data.stride": 30.0,
     "data.filter_sec": 30.0, "loss.contrastive_align_loss": False},
    *({**_KEY_MAP_TINY, **extra} for extra in (
        {"model.mml_fusion": "CA", "model.ca_heads": 2, "model.ca_dim_head": 8,
         "model.ca_mlp_dim": 32},
        {"model.vmr_fusion": "XA-music-video", "loss.vmr_loss": "dual_single_oneloss"},
        {"model.detr_pre_norm": True, "model.decoder_self_attn": False,
         "model.moment_loss": True, "model.audio_short_cut": True},
        {"model.mml_localization": "regression", "model.moment_loss": True},
        {"model.transformer_is_share": True})),
])
def test_key_map_equals_export_uni_state_dict(overrides):
    jcfg, cfg = JaxConfig.from_overrides(overrides), Config.from_overrides(overrides)
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0))
    ours, ref = jax_tree_to_state_dict(params, cfg), export_uni_state_dict(params, jcfg)
    assert ours.keys() == ref.keys()
    assert MaDe(cfg).state_dict().keys() == ours.keys()     # what load_jax_params loads
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_example_batch_equals_graft_entry_generator():
    cfg = Config.from_overrides({"data.max_v_frames": 6, "data.stride": 40.0,
                                 "data.filter_sec": 40.0, "data.vit_dim": 8,
                                 "data.ast_dim": 12})
    ours = example_batch(np.random.RandomState(3), cfg, 5)
    ref = __graft_entry__._example_batch(np.random.RandomState(3), cfg, 5)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours[k].dtype == ref[k].dtype


DATA_TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
             "data.vit_dim": 64, "data.ast_dim": 96}


@pytest.mark.parametrize("seed,family_size,n_unique", [(0, 1, None), (5, 3, None), (7, 2, 9)])
def test_synthetic_generate_equals_jax(tmp_path, seed, family_size, n_unique):
    """The same seed writes a byte-identical CSV (pandas on the JAX side)
    and equal stores; load_csv_index reads it (with pandas on the JAX side)
    into equal arrays of equal dtypes; the datasets assemble equal batches."""
    cfg, jcfg = Config.from_overrides(DATA_TINY), JaxConfig.from_overrides(DATA_TINY)
    ours = synthetic.generate(str(tmp_path / "ours"), n_rows=40, n_unique_music=n_unique,
                              data_cfg=cfg.data, seed=seed, family_size=family_size)
    ref = jax_synthetic.generate(str(tmp_path / "ref"), n_rows=40, n_unique_music=n_unique,
                                 data_cfg=jcfg.data, seed=seed, family_size=family_size)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for store in ("video_store", "music_store"):
        for name in ("feats", "mask", "meta.json"):
            fname = name if name.endswith(".json") else f"{name}.npy"
            with open(tmp_path / "ours" / store / fname, "rb") as a, \
                    open(tmp_path / "ref" / store / fname, "rb") as b:
                assert a.read() == b.read(), (store, name)
    got, want = load_csv_index(ours, 200.0), jax_load_csv_index(ref, 200.0)
    assert got.video_ids == want.video_ids and got.music_ids == want.music_ids
    for k in ("v_duration", "m_duration", "gt_moment", "spans_target", "video_start",
              "video_end"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    ds, jds = synthetic.open_synthetic(str(tmp_path / "ours"), cfg.data), \
        jax_synthetic.open_synthetic(str(tmp_path / "ref"), jcfg.data)
    idx = np.array([3, 0, 3, 17, 39])
    (batch, meta), (jbatch, jmeta) = ds.gather(idx), jds.gather(idx)
    assert batch.keys() == jbatch.keys()
    assert (meta.video_ids, meta.music_ids) == (jmeta.video_ids, jmeta.music_ids)
    np.testing.assert_array_equal(meta.valid, jmeta.valid)
    for k in jbatch:
        assert batch[k].dtype == jbatch[k].dtype, k
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)


@pytest.mark.parametrize("n,bs,shuffle,drop_last,start", [
    (44, 16, True, True, 0), (44, 16, False, False, 0), (44, 16, True, False, 1),
    (50, 7, True, True, 3), (5, 8, False, False, 0)])
def test_epoch_index_batches_equal_jax(n, bs, shuffle, drop_last, start):
    for epoch in (0, 3):
        kw = dict(shuffle=shuffle, seed=11, epoch=epoch, drop_last=drop_last, start_batch=start)
        got = list(epoch_index_batches(n, bs, **kw))
        want = list(jax_epoch_index_batches(n, bs, **kw))
        assert len(got) == len(want)
        for (i, v), (ji, jv) in zip(got, want):
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_array_equal(v, jv)


def test_native_gather_source_is_a_copy():
    """runtime/mgsv_io.cc, the native gather the port builds, is the JAX
    package's byte for byte."""
    import mgsv_tpu.runtime.native as jax_native
    from mgsv_tpu_torch.runtime import native
    with open(native.SOURCE, "rb") as a, open(jax_native._SRC, "rb") as b:
        assert a.read() == b.read()


def test_best_metric_tracker_equals_jax():
    rng = np.random.default_rng(0)
    ours, ref = BestMetricTracker(), JaxBestMetricTracker()
    for epoch in range(1, 30):
        # a coarse grid, so ties (>= and strict > differ) happen
        metrics = {k: float(np.round(rng.random() * 4) / 4) for k in
                   ("R1", "R5", "mIoU", "R1_iou0.5", "R1_iou0.7")}
        assert ours.update(epoch, metrics) == ref.update(epoch, metrics)
        assert ours.best == ref.best
        assert ours.last_best_epoch() == ref.last_best_epoch()
        assert ours.should_stop(epoch, 10, 5) == ref.should_stop(epoch, 10, 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_ranks_equal_jax(seed):
    """The numpy dedup_rank and rect_rank copies, on similarities with
    duplicated ids and exact ties."""
    rng = np.random.default_rng(seed)
    n = 30
    ids = [f"m{j}" for j in rng.integers(0, 12, n)]
    sim = np.round(rng.standard_normal((n, n)) * 2) / 2
    np.testing.assert_array_equal(dedup_rank(sim, ids), jax_dedup_rank(sim, ids))
    cols = sorted(set(ids)) + ["absent"]
    rect = np.round(rng.standard_normal((n, len(cols))) * 2) / 2
    np.testing.assert_array_equal(rect_rank(rect, cols, ids), jax_rect_rank(rect, cols, ids))


@pytest.mark.parametrize("overrides", [
    {}, {"model.num_moment_queries": 10, "model.detr_dropout": 0.0},
    {"train.gradient_accumulation_steps": 2, "model.fused_temporal": True},
    {"model.dim_input": 32, "model.detr_enc_layers": 1, "model.detr_dec_layers": 2,
     "model.decoder_self_attn": False, "data.max_v_frames": 12, "data.stride": 20.0,
     "data.filter_sec": 20.0, "model.contrastive_dim": 16}],
    ids=["paper", "q10", "accum", "small"])
@pytest.mark.parametrize("batch_size", [1, 512])
def test_flops_equal_jax(overrides, batch_size):
    """core/flops.py's forward_flops and train_step_flops against JAX's, and
    the card's peaks: the H100's by name, None for any other card or type."""
    ours = flops.train_step_flops(Config.from_overrides(overrides), batch_size)
    ref = jax_flops.train_step_flops(JaxConfig.from_overrides(overrides), batch_size)
    assert ours == ref
    assert flops.forward_flops(Config.from_overrides(overrides), batch_size) == \
        jax_flops.forward_flops(JaxConfig.from_overrides(overrides), batch_size)
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3", "float32") == 495.0
    assert flops.peak_tflops("TPU v5 lite") is None
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3", "float16") is None


def test_package_exports_lazily():
    """`import mgsv_tpu_torch` loads its Config alone; MaDe, Trainer and
    evaluate come on first use, as the JAX package's lazy exports do."""
    import mgsv_tpu_torch
    from mgsv_tpu_torch.eval.evaluator import evaluate
    from mgsv_tpu_torch.train.loop import Trainer
    assert (mgsv_tpu_torch.MaDe, mgsv_tpu_torch.Trainer, mgsv_tpu_torch.evaluate) == (
        MaDe, Trainer, evaluate)
    assert set(mgsv_tpu_torch.__all__) >= {"MaDe", "Trainer", "evaluate", "Config"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = ("import sys, mgsv_tpu_torch; print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('torch', 'mgsv_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo, capture_output=True,
                         text=True, timeout=60, env=dict(os.environ, PYTHONPATH=repo))
    assert out.stdout.strip() == "['mgsv_tpu_torch', 'mgsv_tpu_torch.config']", out.stderr
