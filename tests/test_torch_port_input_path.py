"""The port's input path on the CPU: the native gather (runtime/native.py,
data/feature_store.py) against numpy and against the JAX package's, its
refusals, the host pipeline through it; device-resident data
(data/device_data.py) against the host pipeline and JAX's
DeviceResidentData; the residency policy; a forced-resident Trainer and the
evaluator's resident pass against the host paths, bit for bit."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from mgsv_tpu.config import DataConfig as JaxDataConfig
from mgsv_tpu.data import synthetic as jax_synthetic
from mgsv_tpu.data.device_data import DeviceResidentData as JaxDeviceResidentData
from mgsv_tpu.data.feature_store import PackedFeatureStore as JaxPackedFeatureStore
from mgsv_tpu_torch.cli import evaluate as evaluate_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.dataset import MgsvDataset
from mgsv_tpu_torch.data.device_data import (RESIDENT_BUDGET, DeviceResidentData,
                                             dataset_device_bytes, use_device_data)
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore
from mgsv_tpu_torch.data.pipeline import prefetch_epoch
from mgsv_tpu_torch.eval.evaluator import evaluate
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.runtime import native
from mgsv_tpu_torch.train.loop import Trainer

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.temporal_dropout": 0.1,
        "model.contrastive_dim": 32, "model.video_pe_len": 40, "model.audio_pe_len": 40,
        "model.compute_dtype": "float32", "train.batch_size_train": 16,
        "train.batch_size_val": 16}
SMALL_DATA = dict(max_v_frames=8, stride=30.0, filter_sec=30.0, vit_dim=32, ast_dim=48)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    rng = np.random.RandomState(0)
    feats = (rng.randn(37, 5, 16) * 3).astype(np.float16)
    mask = rng.randint(0, 2, (37, 5)).astype(np.uint8)
    PackedFeatureStore.build(root, [f"id{i}" for i in range(37)],
                             {"feats": feats, "mask": mask})
    return root, feats, mask


def test_native_library_builds_keyed_on_its_source():
    lib = native.get_lib()
    assert lib is native.get_lib()
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(path).endswith("_build")


def test_native_gather_matches_numpy_and_jax(store_root):
    root, feats, mask = store_root
    store, memmap = PackedFeatureStore(root), PackedFeatureStore(root, use_native=False)
    jax_store = JaxPackedFeatureStore(root)
    assert isinstance(store.arrays["feats"], native.NativeStore)
    assert isinstance(memmap.arrays["feats"], np.memmap)
    idx = np.asarray([0, 5, 5, 36, 12], np.int64)
    for name, arr in (("feats", feats), ("mask", mask)):
        for dtype in (np.float32, None):
            got = store.gather(name, idx, dtype)
            want = arr[idx] if dtype is None else arr[idx].astype(dtype)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, memmap.gather(name, idx, dtype))
            np.testing.assert_array_equal(got, jax_store.gather(name, idx, dtype))
    assert store.gather("feats", np.zeros(0, np.int64)).shape == (0, 5, 16)
    store.prefetch("feats", idx)
    memmap.prefetch("feats", idx)


def test_f16_widening_is_exact(tmp_path):
    """Subnormals, signed zeros, infinities, NaN: bit for bit numpy's."""
    specials = np.asarray(
        [0.0, -0.0, 1.0, -1.0, 65504.0, -65504.0, 6.1e-5, 5.96e-8, 1e-7, -3e-6,
         np.inf, -np.inf, np.nan, 3.14159], np.float16).reshape(1, -1)
    PackedFeatureStore.build(str(tmp_path), ["a"], {"x": specials})
    out = PackedFeatureStore(str(tmp_path)).gather("x", np.asarray([0]), np.float32)
    np.testing.assert_array_equal(out.view(np.uint32),
                                  specials.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("bad", [[-1], [37], [0, 40, 2]])
def test_out_of_range_rows_raise(store_root, bad):
    store = PackedFeatureStore(store_root[0])
    with pytest.raises(IndexError, match="out of range"):
        store.gather("feats", np.asarray(bad))
    with pytest.raises(IndexError, match="out of range"):
        store.prefetch("mask", np.asarray(bad))


@pytest.mark.parametrize("fault", ["shape", "truncated"])
def test_store_whose_file_disagrees_with_its_metadata_raises(tmp_path, store_root, fault):
    root, feats, mask = store_root
    bad = str(tmp_path / "bad")
    PackedFeatureStore.build(bad, [f"id{i}" for i in range(37)],
                             {"feats": feats, "mask": mask})
    path = os.path.join(bad, "feats.npy")
    if fault == "shape":
        with open(os.path.join(bad, "meta.json")) as f:
            meta = json.load(f)
        meta["arrays"]["feats"]["shape"] = [38, 5, 16]
        with open(os.path.join(bad, "meta.json"), "w") as f:
            json.dump(meta, f)
    else:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 2)
    with pytest.raises(ValueError):
        PackedFeatureStore(bad)


def test_native_store_that_cannot_build_raises(tmp_path, store_root, monkeypatch):
    """No fallback to numpy: a failed build raises with g++'s output."""
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PackedFeatureStore(store_root[0])
    assert PackedFeatureStore(store_root[0], use_native=False).gather(
        "feats", np.asarray([1])).shape == (1, 5, 16)


def _small(tmp_path, n_rows=20, seed=0):
    root = str(tmp_path / f"synth{seed}")
    cfg = Config.from_overrides({f"data.{k}": v for k, v in SMALL_DATA.items()})
    synthetic.generate(root, n_rows=n_rows, n_unique_music=7, data_cfg=cfg.data, seed=seed)
    return root, cfg


def test_host_pipeline_yields_every_batch_through_the_native_gather(tmp_path):
    root, cfg = _small(tmp_path, seed=1)
    ds = synthetic.open_synthetic(root, cfg.data)
    assert isinstance(ds.video_store.arrays["feats"], native.NativeStore)
    memmap = MgsvDataset(ds.index, PackedFeatureStore(os.path.join(root, "video_store"),
                                                      use_native=False),
                         PackedFeatureStore(os.path.join(root, "music_store"),
                                            use_native=False))
    got = list(prefetch_epoch(ds, 8, shuffle=True, seed=3, epoch=1, device="cpu"))
    assert len(got) == 2                                   # 20 rows, bs 8, drop_last
    want = list(prefetch_epoch(memmap, 8, shuffle=True, seed=3, epoch=1, device="cpu"))
    for (b, m), (wb, wm) in zip(got, want):
        assert m.video_ids == wm.video_ids
        for k in wb:
            assert b[k].dtype == wb[k].dtype and torch.equal(b[k], wb[k]), k
    ids = lambda epoch: [m.video_ids for _, m in prefetch_epoch(
        ds, 8, shuffle=True, seed=3, epoch=epoch, device="cpu")]
    assert ids(1) == [m.video_ids for _, m in got]
    assert ids(1) != ids(2)


@pytest.mark.parametrize("shuffle,drop_last,bs,start", [
    (True, True, 8, 0), (False, False, 8, 0), (False, False, 16, 0), (True, True, 4, 2)])
def test_resident_batches_equal_host_and_jax(tmp_path, shuffle, drop_last, bs, start):
    """Every key of every resident batch (dtypes included) equals the host
    pipeline's and JAX's DeviceResidentData's for the same seeded stream."""
    root, cfg = _small(tmp_path)
    ds = synthetic.open_synthetic(root, cfg.data)
    jds = jax_synthetic.open_synthetic(root, JaxDataConfig(**SMALL_DATA))
    dd = DeviceResidentData(ds, "cpu")
    assert len(dd) == len(ds) and dd.num_batches(bs, drop_last) == ds.num_batches(bs, drop_last)
    assert dataset_device_bytes(ds) == sum(
        a.nbytes for s in ("video_store", "music_store") for a in
        (np.load(os.path.join(root, s, f"{n}.npy")) for n in ("feats", "mask")))
    kw = dict(shuffle=shuffle, seed=42, epoch=3, drop_last=drop_last, start_batch=start)
    host = list(ds.epoch_batches(bs, **kw))
    dev = list(dd.epoch_batches(bs, **kw))
    ref = list(JaxDeviceResidentData(jds).epoch_batches(bs, **kw))
    assert len(host) == len(dev) == len(ref) > 0
    for (hb, hm), (db, dm), (jb, jm) in zip(host, dev, ref):
        assert hm.video_ids == dm.video_ids == jm.video_ids
        assert hm.music_ids == dm.music_ids
        np.testing.assert_array_equal(hm.valid, dm.valid)
        assert db.keys() == hb.keys() == set(jb)
        for key in hb:
            want = torch.from_numpy(np.ascontiguousarray(hb[key]))
            assert db[key].dtype == want.dtype and torch.equal(db[key], want), key
            np.testing.assert_array_equal(db[key].numpy(), np.asarray(jb[key]), err_msg=key)


class _Stores:
    """A dataset's store surface with arrays of given shapes, no files."""

    def __init__(self, video_rows, music_rows):
        arr = lambda shape, dtype: types.SimpleNamespace(shape=shape, dtype=np.dtype(dtype))
        self.video_store = types.SimpleNamespace(arrays={
            "feats": arr((video_rows, 50, 512), np.float16), "mask": arr((video_rows, 50), "u1")})
        self.music_store = types.SimpleNamespace(arrays={
            "feats": arr((music_rows, 96, 768), np.float16), "mask": arr((music_rows, 96), "u1")})


# MGSV-EC's scale (53k videos, 4k tracks) is under the budget; ten times the
# videos is over it
UNDER, OVER = _Stores(53_000, 4_000), _Stores(530_000, 4_000)


@pytest.mark.parametrize("mode,device,data,want", [
    ("on", "cpu", OVER, True), ("on", "cuda", OVER, True),
    ("off", "cpu", UNDER, False), ("off", "cuda", UNDER, False),
    ("auto", "cpu", UNDER, False), ("auto", "cpu", OVER, False),
    ("auto", "cuda", UNDER, True), ("auto", "cuda", OVER, False)])
def test_device_data_policy(mode, device, data, want):
    assert (dataset_device_bytes(data) < RESIDENT_BUDGET) == (data is UNDER)
    assert use_device_data(mode, device, data) is want


def test_device_data_policy_refuses_other_values_and_a_mesh(tmp_path):
    with pytest.raises(ValueError, match="device_data"):
        use_device_data("yes", "cpu", UNDER)
    root, cfg = _small(tmp_path)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        DeviceResidentData(synthetic.open_synthetic(root, cfg.data), "cpu", mesh=object())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = Config.from_overrides(TINY)
    root = str(tmp_path_factory.mktemp("data"))
    synthetic.generate(root, n_rows=44, n_unique_music=20, data_cfg=cfg.data, seed=0)
    return root, synthetic.open_synthetic(root, cfg.data)


def _cfg(tmp_path, name, **train):
    cfg = Config.from_overrides(TINY)
    return cfg.replace(train=dataclasses.replace(cfg.train, output_dir=str(tmp_path / name),
                                                 **train))


def test_forced_resident_trainer_equals_host_trainer(tmp_path, data):
    """device_data "on" on the CPU makes train and validation data resident
    (one shared copy); "off" and "auto" (on the CPU) keep the host pipeline.
    Two epochs with dropout: the records and the last checkpoint equal bit
    for bit."""
    runs = {}
    for mode in ("on", "off", "auto"):
        trainer = Trainer(_cfg(tmp_path, mode, epochs=2, device_data=mode),
                          train_data=data[1], val_data=data[1], device="cpu")
        assert isinstance(trainer.train_data, DeviceResidentData) == (mode == "on")
        assert trainer.val_data is trainer.train_data
        out = trainer.fit()
        runs[mode] = (out["history"], trainer.ckpt.restore("last"))
    for mode in ("off", "auto"):
        (hist, last), (want_hist, want_last) = runs["on"], runs[mode]
        for a, b in zip(hist, want_hist):
            a_train = {k: v for k, v in a["train"].items() if k not in ("seconds", "clips_per_sec")}
            assert a_train == {k: b["train"][k] for k in a_train} and a["eval"] == b["eval"]
        assert last["step"] == want_last["step"] == 4
        for k, v in want_last["params"].items():
            assert torch.equal(last["params"][k], v), k


def test_resident_evaluate_equals_host_loop(tmp_path, data):
    """The resident pass over 44 rows at batch 16 (a padded tail of 4 rows)
    gives the host loop's outputs bit for bit."""
    root, ds = data
    cfg = _cfg(tmp_path, "eval")
    model = MaDe(cfg, torch.Generator().manual_seed(0)).eval()
    host = evaluate(model, ds, cfg)
    res = evaluate(model, DeviceResidentData(ds, "cpu"), cfg)
    assert res.keys() == host.keys()
    assert torch.equal(res["sim"], host["sim"])
    for key in ("ranks", "ious", "pred_spans"):
        assert res[key].dtype == host[key].dtype
        np.testing.assert_array_equal(res[key], host[key], err_msg=key)
    for key in ("loss", "retrieval", "localization", "composite", "video_ids", "music_ids",
                "ret_results"):
        assert res[key] == host[key], key
    with pytest.raises(ValueError, match="resident data on"):
        evaluate(model, DeviceResidentData(ds, "meta"), cfg)


def test_evaluate_cli_honours_device_data(tmp_path, data, caplog):
    """`--train.device_data on` evaluates the split resident (the log says
    so), with the metrics of "off"."""
    root, _ = data
    args = ["--device", "cpu", "--split", "val", "--data.val_csv",
            os.path.join(root, "data.csv"), "--data.feature_root", root,
            *[a for k, v in TINY.items() for a in (f"--{k}", str(v))]]
    caplog.set_level("INFO")
    on = evaluate_cli.main([*args, "--train.device_data", "on"])
    assert "device-resident dataset enabled" in caplog.text
    caplog.clear()
    off = evaluate_cli.main([*args, "--train.device_data", "off"])
    assert "device-resident dataset enabled" not in caplog.text
    assert on == off
