"""The port's feature-extraction CLI against the JAX package's, end to end on
the CPU: the same seeded JPEG frame directories, WAV tracks (one at another
sample rate, so the resampler runs) and reference-format tower checkpoints
through `mgsv_tpu.cli.extract_features` and
`mgsv_tpu_torch.cli.extract_features`, at tests/test_cli_rawmedia.py's
tiny geometry.  Then the port's 2-shard extraction and merge against its
single-process run, `--convert-from` against the JAX converter, and the
refusal of `--device cuda` without a card.

Tolerance: the stores hold float16 features, rounded on both sides from
float32 encodings that differ by summation order (about 1e-7), so a value
may round to the neighbouring float16: features agree within one float16
ulp of their magnitude; ids and masks are equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from mgsv_tpu.cli import extract_features as jax_cli
from mgsv_tpu_torch.cli import extract_features as port_cli
from mgsv_tpu_torch.data import synthetic_raw
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore

DATA = ["--data.image_resolution", "16", "--data.max_v_frames", "4",
        "--data.max_m_duration", "20.0", "--data.stride", "10.0",
        "--data.filter_sec", "10.0", "--data.mel_bins", "16",
        "--data.target_length", "16", "--data.sample_rate", "8000",
        "--data.vit_dim", "12", "--data.ast_dim", "24"]
N_VIDEOS, N_TRACKS = 12, 5
TRACK_SECONDS = (20.0, 14.0, 9.0, 20.0, 3.0)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Frames, tracks, CSV and checkpoints; returns the CLI's common args."""
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(11)
    rows = []
    for i in range(N_VIDEOS):
        seconds = 2 + i % 4
        synthetic_raw.write_frames(str(root / "frames" / f"v{i}"), rng, seconds, size=(24, 16))
        rows.append({"video_id": f"v{i}", "music_id": f"m{i % N_TRACKS}", "video_start": 0.0,
                     "video_end": seconds - 0.6, "music_start": 1.0, "music_end": 7.0,
                     "music_total_duration": TRACK_SECONDS[i % N_TRACKS]})
    os.makedirs(root / "audio")
    for j, seconds in enumerate(TRACK_SECONDS):
        synthetic_raw.write_wav(str(root / "audio" / f"m{j}.wav"), rng, seconds,
                                11025 if j == 1 else 8000)
    synthetic_raw.write_csv(str(root / "data.csv"), rows)
    synthetic_raw.mint_clip_checkpoint(str(root / "clip.pt"), rng, width=16, depth=1, patch=8,
                                       grid=2, out_dim=12)
    synthetic_raw.mint_ast_checkpoint(str(root / "ast.pth"), rng, dim=24, depth=1, label_dim=5,
                                      f_dim=1, t_dim=1)
    return root, ["--csv", str(root / "data.csv"), "--frames-root", str(root / "frames"),
                  "--audio-root", str(root / "audio"), "--clip-ckpt", str(root / "clip.pt"),
                  "--ast-ckpt", str(root / "ast.pth"), "--batch", "8", *DATA]


def _store_files(root):
    out = {}
    for store in ("video_store", "music_store"):
        for name in ("feats.npy", "mask.npy"):
            with open(os.path.join(root, store, name), "rb") as f:
                out[store, name] = f.read()
        with open(os.path.join(root, store, "meta.json")) as f:
            out[store, "meta.json"] = json.load(f)
    return out


def test_extraction_matches_jax_cli(media, tmp_path):
    root, common = media
    jax_cli.main([*common, "--out", str(tmp_path / "jax"), "--platform", "cpu"])
    stats = port_cli.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert (stats["videos"], stats["tracks"]) == (N_VIDEOS, N_TRACKS)
    for store, width, length in (("video_store", 12, 4), ("music_store", 24, 2)):
        ours = PackedFeatureStore(str(tmp_path / "port" / store), use_native=False)
        theirs = PackedFeatureStore(str(tmp_path / "jax" / store), use_native=False)
        assert ours.ids == theirs.ids
        assert ours.arrays["feats"].dtype == np.float16 and ours.arrays["mask"].dtype == np.uint8
        assert ours.arrays["feats"].shape == (len(ours.ids), length, width)
        np.testing.assert_array_equal(ours.arrays["mask"], theirs.arrays["mask"])
        a = np.asarray(ours.arrays["feats"], np.float32)
        b = np.asarray(theirs.arrays["feats"], np.float32)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(a - b) <= ulp), np.abs(a - b).max()
    # masks as the rules give them: frames 0..floor(end), snippet centers <= duration
    video = PackedFeatureStore(str(tmp_path / "port" / "video_store"), use_native=False)
    assert video.arrays["mask"].sum(axis=1).tolist() == [
        min(2 + i % 4 - 1, 3) + 1 for i in range(N_VIDEOS)]
    music = PackedFeatureStore(str(tmp_path / "port" / "music_store"), use_native=False)
    assert music.arrays["mask"].tolist() == [[1, 1], [1, 1], [1, 0], [1, 1], [1, 0]]


def test_sharded_extraction_merges_to_the_single_process_stores(media, tmp_path):
    _, common = media
    full, sharded = str(tmp_path / "full"), str(tmp_path / "sharded")
    port_cli.main([*common, "--out", full, "--device", "cpu"])
    for k in range(2):
        port_cli.main([*common, "--out", sharded, "--device", "cpu", "--num-shards", "2",
                       "--shard-index", str(k)])
    assert os.path.isdir(os.path.join(sharded, "shard_1", "music_store"))
    port_cli.main([*common, "--out", sharded, "--merge-shards", "2"])
    assert _store_files(full) == _store_files(sharded)


def test_convert_from_reference_features_matches_jax(media, tmp_path):
    root, _ = media
    src = tmp_path / "Kuai_feature"
    rng = np.random.default_rng(12)
    for sub, ids, shape in (("vit_feature1", [f"v{i}" for i in range(N_VIDEOS)], (4, 12)),
                            ("ast_feature2p5", [f"m{j}" for j in range(N_TRACKS)], (2, 24))):
        for kind in ("feature", "mask"):
            d = src / sub / f"{sub.split('_')[0]}_{kind}"
            d.mkdir(parents=True)
            for i in ids:
                x = rng.standard_normal(shape) if kind == "feature" else rng.random(shape[0]) > 0.4
                torch.save(torch.from_numpy(x.astype(np.float32)), str(d / f"{i}.pt"))
    args = ["--csv", str(root / "data.csv"), "--convert-from", str(src)]
    jax_cli.main([*args, "--out", str(tmp_path / "jax"), "--platform", "cpu"])
    port_cli.main([*args, "--out", str(tmp_path / "port")])
    assert _store_files(str(tmp_path / "jax")) == _store_files(str(tmp_path / "port"))


def test_cuda_device_without_a_card_raises(media, tmp_path, monkeypatch):
    _, common = media
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main([*common, "--out", str(tmp_path / "x"), "--device", "cuda"])
    assert not os.path.exists(tmp_path / "x")
