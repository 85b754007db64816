"""The port's training loop (train/loop.py::Trainer), checkpoints
(core/checkpoint.py) and CLIs (cli/train.py, cli/evaluate.py) on the CPU at
tiny widths, dropout on: the records and checkpoints a run writes, a
step-granular preemption and resume that replays bit for bit, the NaN
guard, the crash windows of the `last` rotation, the CLIs' outputs
against the JAX package's formats, the input pipeline's error path and the
step profiler."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.eval import metrics as JM
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.train.loop import EpochStats as JaxEpochStats
from mgsv_tpu_torch.cli import evaluate as evaluate_cli
from mgsv_tpu_torch.cli import train as train_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.checkpoint import CheckpointManager
from mgsv_tpu_torch.core.profiling import StepProfiler
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.loop import Preempted, Trainer

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.temporal_dropout": 0.1,
        "model.contrastive_dim": 32, "model.video_pe_len": 40, "model.audio_pe_len": 40,
        "model.compute_dtype": "float32", "train.batch_size_train": 16,
        "train.batch_size_val": 16}
TINY_ARGS = [a for k, v in TINY.items() for a in (f"--{k}", str(v))]
TAGS = ("best_r1", "best_iou", "best_r1iou07", "last")


def _cfg(tmp_path, name, **train):
    cfg = Config.from_overrides(TINY)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, output_dir=str(tmp_path / name), **train))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = Config.from_overrides(TINY)
    root = str(tmp_path_factory.mktemp("data"))
    synthetic.generate(root, n_rows=48, n_unique_music=24, data_cfg=cfg.data, seed=0)
    return synthetic.open_synthetic(root, cfg.data)


def _jax_record_keys():
    """The keys of a JAX history record's "train" and "eval" parts."""
    ranks, iou = np.arange(4), np.linspace(0, 1, 4)
    sim = np.eye(4)
    flat = {**JM.recall_metrics(sim, list("abcd"))[0], **JM.iou_metrics(iou),
            **JM.composite_metrics(ranks, iou)}
    return {f.name for f in dataclasses.fields(JaxEpochStats)}, set(flat)


def test_fit_writes_history_and_checkpoints(tmp_path, data):
    cfg = _cfg(tmp_path, "run", epochs=2)
    trainer = Trainer(cfg, train_data=data, val_data=data, device="cpu")
    out = trainer.fit()
    with open(os.path.join(trainer.run_dir, "history.json")) as f:
        history = json.load(f)
    assert history == json.loads(json.dumps(out["history"], default=float))
    train_keys, eval_keys = _jax_record_keys()
    assert [r["epoch"] for r in history] == [1, 2]
    for r in history:
        assert set(r) == {"epoch", "train", "eval"}
        assert set(r["train"]) == train_keys and set(r["eval"]) == eval_keys
        assert r["train"]["steps"] == 3 and np.isfinite(r["train"]["loss"])
    for tag in TAGS:
        assert os.path.isdir(os.path.join(trainer.run_dir, f"ckpt_{tag}")), tag
    last = trainer.ckpt.restore("last")
    assert (last["step"], last["epoch"]) == (6, 2) and last["opt_state"]["count"] == 6
    assert history[0]["train"]["loss"] != history[1]["train"]["loss"]


def _final_state(trainer):
    opt = trainer.optimizer.state_dict()
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in opt["mu"].items()},
            {k: v.clone() for k, v in opt["nu"].items()}, opt["count"])


def test_preemption_resume_is_bit_identical(tmp_path, data):
    """Killed at global step 6 (epoch 2 step 3, one step past the save at
    step 5), resumed from the step-granular 'last': the weights, Adam's
    moments and count, and the epoch records equal an uninterrupted run's
    exactly."""
    full = Trainer(_cfg(tmp_path, "full", epochs=2), train_data=data, val_data=data,
                   device="cpu")
    want = full.fit()
    cfg = _cfg(tmp_path, "pre", epochs=2, checkpoint_every_steps=2, abort_at_step=6)
    first = Trainer(cfg, train_data=data, val_data=data, device="cpu")
    with pytest.raises(Preempted, match="injected preemption"):
        first.fit()
    saved = first.ckpt.restore("last")
    assert (saved["epoch"], saved["step_in_epoch"], saved["step"]) == (2, 2, 5)
    resumed = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, resume="last",
                                                            abort_at_step=0)),
                      train_data=data, val_data=data, device="cpu")
    got = resumed.fit()
    assert [h["epoch"] for h in got["history"]] == [1, 2]
    assert got["history"][1]["train"]["steps"] == 1          # the replayed step only
    for a, b in zip(_final_state(resumed), _final_state(full)):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert a == b
    for e in (0, 1):
        assert got["history"][e]["eval"] == want["history"][e]["eval"]
    assert got["history"][0]["train"]["loss"] == want["history"][0]["train"]["loss"]


class _Poisoned:
    """A dataset whose Nth gather returns NaN frame features."""

    def __init__(self, inner, poison_call):
        self._inner, self._poison, self.calls = inner, poison_call, 0
        self.index = inner.index

    def __len__(self):
        return len(self._inner)

    def num_batches(self, batch_size, drop_last=True):
        return self._inner.num_batches(batch_size, drop_last)

    def gather(self, idx):
        batch, meta = self._inner.gather(idx)
        if self.calls == self._poison:
            batch["frame_feats"] = np.full_like(batch["frame_feats"], np.nan)
        self.calls += 1
        return batch, meta


@pytest.mark.parametrize("poison_call", [3, 4])
def test_nan_guard_leaves_the_epoch_start_state(tmp_path, data, poison_call):
    """Gather 3 is epoch 2's first step (the sampled check), gather 4 its
    second (the epoch-end check): both abort, leave the clean epoch-2-start
    state as 'last', and a resume from it finishes the run."""
    cfg = _cfg(tmp_path, f"nan{poison_call}", epochs=2)
    trainer = Trainer(cfg, train_data=_Poisoned(data, poison_call), val_data=None,
                      device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.fit()
    saved = trainer.ckpt.restore("last")
    assert (saved["epoch"], saved["step"]) == (1, 3) and "opt_state" in saved
    assert all(torch.isfinite(v).all() for v in saved["params"].values())
    assert not all(torch.isfinite(p).all() for p in trainer.model.parameters())
    resumed = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, resume="last")),
                      train_data=data, val_data=None, device="cpu")
    out = resumed.fit()
    assert [h["epoch"] for h in out["history"]] == [1, 2] and resumed.step == 6
    assert all(torch.isfinite(p).all() for p in resumed.model.parameters())


def test_last_rotation_every_crash_window_restorable(tmp_path):
    """Mirrors tests/test_checkpoint_rotation.py for the port's manager."""
    mgr = CheckpointManager(str(tmp_path))
    s1 = {"params": {"w": torch.arange(4.0)}, "step": 1}
    s2 = {"params": {"w": torch.arange(4.0) * 2}, "step": 2}
    last = os.path.join(str(tmp_path), "ckpt_last")
    mgr.save("last", s1)
    mgr.wait()
    assert os.path.isdir(last) and mgr.restore("last")["step"] == 1
    mgr.save("last", s2)
    assert mgr.restore("last")["step"] == 2 and os.path.isdir(last + ".prev")
    # killed after the rotation rename, before the new save's commit
    os.rename(last, last + ".tmp")
    assert mgr.exists("last")
    restored = mgr.restore("last")
    assert restored["step"] == 1
    assert torch.equal(restored["params"]["w"], torch.arange(4.0))
    # killed while writing the new save: the partial temporary is replaced
    mgr.save("last", s2)
    assert mgr.restore("last")["step"] == 2 and not os.path.isdir(last + ".tmp")
    shutil.rmtree(last + ".prev")
    assert not mgr.exists("nope")


def test_cli_train_then_evaluate(tmp_path):
    """cli.train, then cli.evaluate --save-json on its best_r1 checkpoint:
    the metrics equal the run's epoch record, and the per-sample rows have
    the keys of JAX's save_results_json."""
    out_dir = str(tmp_path / "out")
    train_cli.main(["--device", "cpu", "--synthetic", "40", "--train.epochs", "1",
                    "--train.output_dir", out_dir, *TINY_ARGS])
    run_dir, root = os.path.join(out_dir, "made"), os.path.join(out_dir, "synthetic_data")
    with open(os.path.join(run_dir, "history.json")) as f:
        record = json.load(f)[0]["eval"]
    save = str(tmp_path / "results.json")
    results = evaluate_cli.main([
        "--device", "cpu", "--ckpt", "best_r1", "--run-dir", run_dir, "--split", "val",
        "--data.val_csv", os.path.join(root, "data.csv"), "--data.feature_root", root,
        "--save-json", save, *TINY_ARGS])
    assert results["best_r1"] == record
    with open(save) as f:
        rows = json.load(f)
    ref = str(tmp_path / "ref.json")
    JM.save_results_json([dict(music_id="m", rank=1, topk_music_ids=["m"])],
                         [dict(video_id="v", music_id="m", m_duration=200.0,
                               gt_moment=[[1.0, 2.0]], pred_st=1.0, pred_ed=2.0)],
                         np.ones(1), ref)
    with open(ref) as f:
        want_keys = list(json.load(f)[0])
    assert len(rows) == 40 and all(list(r) == want_keys for r in rows)


def test_export_torch_equals_jax_export(tmp_path):
    """--export-torch writes {"epoch", "loss", "model_state_dict"} with the
    keys and values of JAX's export_uni_state_dict for the same weights."""
    cfg, jcfg = Config.from_overrides(TINY), JaxConfig.from_overrides(TINY)
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.device_get(jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(3)))
    model = load_jax_params(MaDe(cfg), params, cfg)
    run_dir = str(tmp_path / "run")
    CheckpointManager(run_dir).save("best_r1", {"params": model.state_dict(), "step": 0,
                                                "epoch": 1})
    out = str(tmp_path / "made.bin")
    evaluate_cli.main(["--device", "cpu", "--ckpt", "best_r1", "--run-dir", run_dir,
                       "--export-torch", out, *TINY_ARGS])
    blob = torch.load(out, map_location="cpu", weights_only=True)
    assert set(blob) == {"epoch", "loss", "model_state_dict"}
    want = export_uni_state_dict(params, jcfg)
    got = blob["model_state_dict"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_prefetch_raises_the_producers_error(data):
    """A gather that fails in the background thread fails the consumer."""
    class Broken(_Poisoned):
        def gather(self, idx):
            if self.calls == 1:
                raise OSError("store unreadable")
            return super().gather(idx)

    batches = prefetch_epoch(Broken(data, poison_call=-1), 16, shuffle=True, device="cpu")
    with pytest.raises(OSError, match="store unreadable"):
        for _ in batches:
            pass


def test_step_profiler_writes_one_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=1, num_steps=2, enabled=True)
    for step in range(5):
        prof.step(step)
        torch.ones(8) @ torch.ones(8)
    prof.close()
    assert os.listdir(tmp_path / "profile") == ["trace_steps_1_3.json"]
    assert not prof.enabled


def test_unported_paths_raise(tmp_path, data):
    """A mesh (multi-device) and a vmr_loss JAX's evaluation refuses raise
    instead of running something else; the EmbeddingNet aggregator and the
    cls token, once refused, build a Trainer whose model holds them
    (tests/test_torch_port_aggregators.py holds them to JAX)."""
    from mgsv_tpu_torch.eval.evaluator import corpus_similarity, evaluate

    cfg = _cfg(tmp_path, "raise")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(cfg, train_data=data, mesh=object(), device="cpu")
    model = MaDe(cfg)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        evaluate(model, data, cfg, mesh=object())
    for over, module in (({"agg_module": "mlp"}, "video_embedding_net"),
                         ({"with_cls_token": True}, "video_cls_token")):
        ported = cfg.replace(model=dataclasses.replace(cfg.model, **over))
        assert hasattr(Trainer(ported, train_data=data, device="cpu").init_state(), module)
    oneloss = cfg.replace(model=dataclasses.replace(cfg.model, vmr_fusion="XA-music-video"),
                          loss=dataclasses.replace(cfg.loss, vmr_loss="dual_single_oneloss"))
    d, s = cfg.model.dim_input, cfg.data.max_snippet_num
    with pytest.raises(ValueError, match="unsupported vmr_loss for eval"):
        corpus_similarity(MaDe(oneloss), torch.ones(3, d), torch.ones(3, d),
                          torch.ones(3, s, d), torch.ones(3, s), oneloss)
