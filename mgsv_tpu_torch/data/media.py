"""Media decoding: WAV audio (stdlib) and video frames (OpenCV), the port's
copy of mgsv_tpu/data/media.py.

WAV decoding uses the stdlib `wave` module (no torchaudio, ffmpeg or
soundfile needed), and direct-video frame sampling (an extension beyond
the reference's pre-extracted JPEG directories) uses OpenCV when present.

Compressed audio: the reference decodes arbitrary formats through
torchaudio's ffmpeg backend (dataloader_MGSV_EC_rawdata.py:119); that
dependency is a deployment choice, not model semantics, so here it is a
PLUGGABLE hook — `register_audio_decoder(".mp3", fn)` routes any extension
to a user-supplied `fn(path) -> (mono float32 waveform in [-1, 1], sr)`
(wrap torchaudio/soundfile/ffmpeg where installed).  Without a registered
decoder, compressed formats raise with a message pointing at the hook and
the packed-feature path.
"""

from __future__ import annotations

import wave
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# extension (lowercase, with dot) -> decoder(path) -> (waveform, sr)
_AUDIO_DECODERS: Dict[str, Callable[[str], Tuple[np.ndarray, int]]] = {}


def register_audio_decoder(
        ext: str, fn: Callable[[str], Tuple[np.ndarray, int]]) -> None:
    """Route `load_audio` for `ext` (e.g. ".mp3") through `fn`.

    `fn(path)` must return (mono float32 waveform in [-1, 1], sample_rate).
    Registering ".wav" overrides the stdlib decoder too."""
    if not ext.startswith("."):
        ext = "." + ext
    _AUDIO_DECODERS[ext.lower()] = fn


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 waveform in [-1, 1] + sample rate."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    import os

    ext = os.path.splitext(path)[1].lower()
    fn = _AUDIO_DECODERS.get(ext)
    if fn is not None:
        wav, sr = fn(path)
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:
            # Convenience downmix for the unambiguous stereo layouts only
            # ([ch<=2, n] or [n, ch<=2]); anything else (multi-channel rigs,
            # tiny clips where either axis could be channels) must be
            # downmixed by the decoder itself — guessing the channel axis
            # wrong silently averages over TIME and feeds garbage onward.
            ch_axis = int(np.argmin(wav.shape))
            if wav.shape[ch_axis] <= 2 and wav.shape[1 - ch_axis] > 2:
                wav = wav.mean(axis=ch_axis)
            else:
                raise ValueError(
                    f"decoder for {ext!r} returned shape {wav.shape}; the "
                    "hook contract is mono [n] (or unambiguous stereo) — "
                    "downmix inside the decoder")
        elif wav.ndim != 1:
            raise ValueError(
                f"decoder for {ext!r} returned rank-{wav.ndim} output; "
                "the hook contract is a mono [n] waveform")
        return wav, int(sr)
    if ext == ".wav":
        return load_wav(path)
    raise RuntimeError(
        f"no decoder for {path!r} in this environment (no ffmpeg/torchaudio); "
        "register one via mgsv_tpu_torch.data.media.register_audio_decoder"
        f"('{ext}', fn), decode offline to WAV, or use the packed feature "
        "store path")


def sample_video_frames(path: str, seconds: np.ndarray,
                        resolution: int = 224) -> np.ndarray:
    """Grab one frame per requested second from a video file via OpenCV and
    CLIP-preprocess each -> [len(seconds), 3, res, res]."""
    import cv2
    from PIL import Image

    from mgsv_tpu_torch.data.frames import preprocess_image

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {path}")
    out = []
    try:
        for sec in seconds:
            cap.set(cv2.CAP_PROP_POS_MSEC, float(sec) * 1000.0)
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"cannot read frame at {sec}s from {path}")
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            out.append(preprocess_image(Image.fromarray(rgb), resolution))
    finally:
        cap.release()
    return np.stack(out)
