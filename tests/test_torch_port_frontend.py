"""The port's copies of the JAX package's raw-media frontend agree with the
originals on seeded inputs: the kaldi fbank and its mel banks, the
resampler, the snippet windower, CLIP frame preprocessing and per-second
frame loading, WAV decoding and the decoder hook, and the reference-feature
converter; `fbank_torch` agrees with `fbank_jax`.

The numpy copies run the same operations as the originals, so they are held
equal bit for bit; `fbank_torch` against `fbank_jax` within 1e-3 abs on
log-mel values of order 10: two float32 FFTs differ by a few 1e-5 relative
in the power, which the log turns into up to 3e-4 in the quietest bins (the
JAX package's own test holds fbank_jax to its numpy fbank within 2e-3).
"""

import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.data import audio as jax_audio
from mgsv_tpu.data import frames as jax_frames
from mgsv_tpu.data import media as jax_media
from mgsv_tpu.data.feature_store import PackedFeatureStore as JaxStore
from mgsv_tpu.data.feature_store import convert_reference_features as jax_convert
from mgsv_tpu_torch.data import audio, frames, media
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore, convert_reference_features


@pytest.mark.parametrize("seconds,sr", [(1.0, 16000), (10.26, 16000), (0.5, 8000)])
def test_fbank_equals_jax(seconds, sr):
    wav = np.random.default_rng(0).standard_normal(int(seconds * sr)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(audio.fbank(wav, sr), jax_audio.fbank(wav, sr))
    np.testing.assert_array_equal(audio.mel_banks(128, 512, float(sr)),
                                  jax_audio.mel_banks(128, 512, float(sr)))


@pytest.mark.parametrize("orig_sr", [44100, 22050, 8000])
def test_resamplers_equal_jax(orig_sr):
    wav = np.random.default_rng(orig_sr).standard_normal(orig_sr // 2).astype(np.float32)
    np.testing.assert_array_equal(audio.resample_sinc(wav, orig_sr, 16000),
                                  jax_audio.resample_sinc(wav, orig_sr, 16000))
    np.testing.assert_array_equal(audio.resample_linear(wav, orig_sr, 16000),
                                  jax_audio.resample_linear(wav, orig_sr, 16000))


@pytest.mark.parametrize("seconds", [35.0, 12.0])
def test_extract_snippets_equals_jax(seconds):
    """A 30 s catalog at 8 kHz, 5 s stride, 10 s windows, 32 mel x 64 frames:
    the last snippets of the 12 s track are masked and zero-padded."""
    sr = 8000
    wav = np.random.default_rng(1).standard_normal(int(seconds * sr)).astype(np.float32) * 0.1
    args = (wav, sr, 30.0, 5.0, 10.0, 0.0, 32, 64)
    ours, theirs = audio.extract_snippets(*args), jax_audio.extract_snippets(*args)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(audio.snippet_windows(30.0, 5.0, 10.0, 1.0),
                                  jax_audio.snippet_windows(30.0, 5.0, 10.0, 1.0))


def test_fbank_torch_matches_fbank_jax():
    rng = np.random.default_rng(2)
    wav = rng.standard_normal(16000).astype(np.float32) * 0.1
    win, shift = 400, 160
    idx = np.arange(win)[None, :] + shift * np.arange(1 + (len(wav) - win) // shift)[:, None]
    framed = wav[idx][None]                                   # [1, T, win]
    mel = audio.mel_banks(128, 512, 16000.0)
    window = audio._hanning(win)
    want = np.asarray(jax_audio.fbank_jax(jnp.asarray(framed), jnp.asarray(mel),
                                          jnp.asarray(window)))
    got = audio.fbank_torch(torch.from_numpy(framed), torch.from_numpy(mel),
                            torch.from_numpy(window))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def _write_frames(root, rng, n, size=(40, 30)):
    from PIL import Image

    os.makedirs(root)
    for sec in range(n):
        img = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"{sec}.jpg"))


def test_frame_preprocessing_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    _write_frames(str(tmp_path / "v"), rng, 6)
    img = Image.open(str(tmp_path / "v" / "0.jpg"))
    np.testing.assert_array_equal(frames.preprocess_image(img, 24),
                                  jax_frames.preprocess_image(img, 24))
    np.testing.assert_array_equal(frames.black_frame(24), jax_frames.black_frame(24))
    # the last frame falls back to end.jpg; frames past the window are black
    os.rename(str(tmp_path / "v" / "5.jpg"), str(tmp_path / "v" / "end.jpg"))
    for start, end, max_frames in ((0.0, 5.4, 8), (1.2, 3.9, 8), (0.0, 5.4, 4)):
        ours = frames.load_clip_frames(str(tmp_path / "v"), start, end, max_frames, 24)
        theirs = jax_frames.load_clip_frames(str(tmp_path / "v"), start, end, max_frames, 24)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    with pytest.raises(ValueError, match="empty frame window"):
        frames.load_clip_frames(str(tmp_path / "v"), 7.0, 9.0, 4, 24)


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (1, 1), (4, 1)])
def test_load_wav_equals_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dtype))
    pcm = rng.integers(info.min, info.max, 4000 * channels).astype(dtype)
    path = str(tmp_path / "t.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    ours, theirs = media.load_wav(path), jax_media.load_wav(path)
    assert ours[1] == theirs[1] == 22050
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(media.load_audio(path)[0], ours[0])


def test_audio_decoder_hook_equals_jax(tmp_path, monkeypatch):
    """A registered decoder serves its extension (a stereo [2, n] result is
    downmixed); an unregistered compressed format raises, on both sides."""
    monkeypatch.setattr(media, "_AUDIO_DECODERS", {})
    monkeypatch.setattr(jax_media, "_AUDIO_DECODERS", {})
    stereo = np.random.default_rng(4).standard_normal((2, 500)).astype(np.float32)
    for mod in (media, jax_media):
        mod.register_audio_decoder("MP3", lambda path: (stereo, 44100))
    path = str(tmp_path / "t.mp3")
    ours, theirs = media.load_audio(path), jax_media.load_audio(path)
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1] == 44100
    for mod in (media, jax_media):
        with pytest.raises(RuntimeError, match="no decoder"):
            mod.load_audio(str(tmp_path / "t.flac"))
        mod.register_audio_decoder(".ogg", lambda path: (np.zeros((3, 3, 3)), 1))
        with pytest.raises(ValueError, match="rank-3"):
            mod.load_audio(str(tmp_path / "t.ogg"))


def test_convert_reference_features_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    fdir, mdir = tmp_path / "feat", tmp_path / "mask"
    fdir.mkdir()
    mdir.mkdir()
    for i in ("a", "b", "c"):
        torch.save(torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
                   str(fdir / f"{i}.pt"))
        torch.save(torch.from_numpy((rng.random(4) > 0.3).astype(np.float32)),
                   str(mdir / f"{i}.pt"))
    ids = ["b", "a", "b", "c", "a"]
    ours = convert_reference_features(str(fdir), str(mdir), ids, str(tmp_path / "ours"))
    theirs = jax_convert(str(fdir), str(mdir), ids, str(tmp_path / "theirs"))
    assert isinstance(ours, PackedFeatureStore) and isinstance(theirs, JaxStore)
    assert ours.ids == theirs.ids == ["b", "a", "c"]
    for name in ("feats", "mask"):
        with open(tmp_path / "ours" / f"{name}.npy", "rb") as a, \
                open(tmp_path / "theirs" / f"{name}.npy", "rb") as b:
            assert a.read() == b.read(), name
