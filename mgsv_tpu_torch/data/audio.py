"""Audio frontend: kaldi-compatible log-mel fbank + snippet windower, the
port's copy of mgsv_tpu/data/audio.py (numpy; the JAX module's device
variant `fbank_jax` is `fbank_torch` here).

The reference's raw-audio pipeline (dataloader_MGSV_EC_rawdata.py:95-158):

  waveform -> resample 16 kHz -> pad/trim to 240 s -> sliding windows of
  `filter`=10 s every `stride`=2.5 s -> per-window kaldi fbank (25 ms
  frames / 10 ms shift, hanning window, 128 mel bins, dither 0,
  htk_compat, use_energy False) -> pad/trim to 1024 frames -> normalize
  (x + 4.2677393) / (4.5689974 * 2) -> [96, 1024, 128] + snippet mask.

The fbank itself follows torchaudio.compliance.kaldi.fbank's algorithm with
the reference's arguments and kaldi defaults (snip_edges=True,
remove_dc_offset=True, preemphasis 0.97, round_to_power_of_two, HTK mel
scale, low 20 Hz, high Nyquist).  Vectorized numpy on the host;
`fbank_torch` computes the heavy part (FFT + mel projection) of batched
equal-length windows in PyTorch, on any device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000
FRAME_LENGTH_MS = 25.0
FRAME_SHIFT_MS = 10.0
PREEMPH = 0.97
LOW_FREQ = 20.0
EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, kaldi's log floor

# AST input normalization constants (dataloader_MGSV_EC_rawdata.py:155)
AST_NORM_MEAN = -4.2677393
AST_NORM_STD = 4.5689974


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, fft_size: int, sample_rate: float,
              low_freq: float = LOW_FREQ, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel filterbank [num_bins, fft_size // 2 + 1].

    Cached: extract_snippets calls fbank 96x per track, and a real catalog
    has thousands of tracks — the [128, 257] weights are a pure function
    of the arguments.  Callers must NOT mutate the returned array.

    Kaldi computes each bin's weight from the mel-scale distance between the
    FFT bin's mel frequency and the triangle's left/center/right points.
    """
    if high_freq <= 0.0:
        high_freq = sample_rate / 2 + high_freq
    fft_freqs = np.arange(fft_size // 2 + 1) * (sample_rate / fft_size)
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_f = mel_scale(fft_freqs)                              # [F]
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta       # [B, 1]
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_f[None, :] - left) / mel_delta
    down = (right - mel_f[None, :]) / mel_delta
    weights = np.maximum(0.0, np.minimum(up, down))
    # kaldi zeroes weights outside (left, right) exactly
    weights[(mel_f[None, :] <= left) | (mel_f[None, :] >= right)] = 0.0
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hanning(n: int) -> np.ndarray:
    # kaldi "hanning": 0.5 - 0.5 cos(2 pi k / (N - 1))
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))).astype(np.float32)


def fbank(
    waveform: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    num_mel_bins: int = 128,
    frame_length_ms: float = FRAME_LENGTH_MS,
    frame_shift_ms: float = FRAME_SHIFT_MS,
    preemphasis: float = PREEMPH,
    remove_dc_offset: bool = True,
    round_to_power_of_two: bool = True,
) -> np.ndarray:
    """Log-mel fbank of a mono waveform [n] -> [num_frames, num_mel_bins].

    Matches torchaudio.compliance.kaldi.fbank with the reference's arguments
    (dither=0, hanning, htk_compat=True, use_energy=False — htk_compat only
    affects energy placement, so it is a no-op here) and kaldi defaults.
    """
    wav = np.asarray(waveform, np.float32).reshape(-1)
    win = int(sample_rate * frame_length_ms / 1000)           # 400
    shift = int(sample_rate * frame_shift_ms / 1000)          # 160
    if len(wav) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    num_frames = 1 + (len(wav) - win) // shift                # snip_edges
    idx = np.arange(win)[None, :] + shift * np.arange(num_frames)[:, None]
    frames = wav[idx]                                         # [T, win]

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        # kaldi: x[i] -= p * x[i-1], with x[-1] := x[0]
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    frames = frames * _hanning(win)[None, :]

    fft_size = _next_pow2(win) if round_to_power_of_two else win
    spec = np.fft.rfft(frames, n=fft_size, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)

    mel = power @ mel_banks(num_mel_bins, fft_size, sample_rate).T
    return np.log(np.maximum(mel, EPSILON)).astype(np.float32)


def snippet_windows(
    max_m_duration: float, stride: float, filter_sec: float,
    padding: float = 0.0,
) -> np.ndarray:
    """[(start_s, end_s)] per snippet — dataloader_MGSV_EC_rawdata.py:134-141."""
    centers = np.arange(0, max_m_duration, stride)
    starts = np.maximum(0.0 - padding, centers - filter_sec / 2)
    ends = np.minimum(max_m_duration + padding, centers + filter_sec / 2)
    return np.stack([starts, ends], axis=-1)


def extract_snippets(
    waveform: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    max_m_duration: float = 240.0,
    stride: float = 2.5,
    filter_sec: float = 10.0,
    padding: float = 0.0,
    num_mel_bins: int = 128,
    target_length: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full raw-audio path for one track.

    waveform: mono float [n] at `sample_rate`.
    Returns (snippets [S, target_length, mel], mask [S]) — exactly
    get_ast_rawaudio's output contract (dataloader_MGSV_EC_rawdata.py:95-158),
    including the mask rule `center <= true_duration` and the AST input
    normalization.
    """
    wav = np.asarray(waveform, np.float32).reshape(-1)
    m_duration = len(wav) / sample_rate
    total = int(sample_rate * max_m_duration)
    if len(wav) < total:
        wav = np.concatenate([wav, np.zeros(total - len(wav), np.float32)])
    else:
        wav = wav[:total]

    num_snippets = int(max_m_duration / stride)
    windows = snippet_windows(max_m_duration, stride, filter_sec, padding)
    centers = np.arange(0, max_m_duration, stride)

    snippets = np.zeros((num_snippets, target_length, num_mel_bins), np.float32)
    mask = np.zeros(num_snippets, np.float32)
    for i in range(num_snippets):
        if centers[i] <= m_duration:
            mask[i] = 1.0
        s0 = int(sample_rate * windows[i, 0])
        s1 = int(sample_rate * windows[i, 1])
        fb = fbank(wav[s0:s1], sample_rate, num_mel_bins)
        t = min(target_length, fb.shape[0])
        snippets[i, :t] = fb[:t]                              # zero-pad tail
    snippets = (snippets - AST_NORM_MEAN) / (AST_NORM_STD * 2)
    return snippets, mask


def resample_sinc(
    waveform: np.ndarray,
    orig_sr: int,
    new_sr: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Polyphase windowed-sinc resampler — torchaudio.transforms.Resample
    semantics (the reference resamples with it at
    dataloader_MGSV_EC_rawdata.py:119-121).

    Algorithm: reduce the rate pair by their gcd, build `new` phase kernels
    of a Hann^2-windowed sinc low-passed at `rolloff * min(orig, new)`, and
    apply them as a strided correlation (one output sample per phase per
    input block of `orig` samples).  Matches torchaudio's
    `sinc_interp_hann` semantics within 1e-4 (the JAX package's copy is
    tested against torchaudio and against float64 golden fixtures; this
    copy is held equal to it).
    """
    if orig_sr == new_sr:
        return np.asarray(waveform, np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    orig, new = int(orig_sr) // g, int(new_sr) // g

    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig     # [K]
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx  # [new, K]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * (base_freq / orig)                             # [new, K]

    wav = np.asarray(waveform, np.float64).reshape(-1)
    length = len(wav)
    padded = np.pad(wav, (width, width + orig))
    k = 2 * width + orig
    n_blocks = (len(padded) - k) // orig + 1
    frames = padded[np.arange(k)[None, :] + orig * np.arange(n_blocks)[:, None]]
    out = (frames @ kernels.T).reshape(-1)           # interleave the phases
    target_length = int(math.ceil(new * length / orig))
    return out[:target_length].astype(np.float32)


def resample_linear(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Simple linear resampler — kept as a cheap fallback; `resample_sinc`
    is the default (torchaudio-compatible) path."""
    if orig_sr == new_sr:
        return np.asarray(waveform, np.float32)
    n_out = int(round(len(waveform) * new_sr / orig_sr))
    x_old = np.arange(len(waveform), dtype=np.float64) / orig_sr
    x_new = np.arange(n_out, dtype=np.float64) / new_sr
    return np.interp(x_new, x_old, waveform).astype(np.float32)


# ---------------------------------------------------------------------------
# PyTorch variant for batched windows of equal length
# ---------------------------------------------------------------------------

def fbank_torch(frames_batch, mel_weights, window):
    """Batched fbank core: [B, T, win] framed audio -> [B, T, mel] log-mel
    (tensors on any one device; mel_weights [mel, fft_bins], window [win]).

    Callers frame on the host (a cheap strided view) and ship the FFT and
    the mel projection to the device."""
    import torch

    x = frames_batch - frames_batch.mean(dim=-1, keepdim=True)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x = (x - PREEMPH * prev) * window
    fft_size = _next_pow2(x.shape[-1])
    spec = torch.fft.rfft(x, n=fft_size, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.einsum("...f,mf->...m", power, mel_weights)
    return torch.log(torch.clamp(mel, min=EPSILON))
