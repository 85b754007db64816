"""Philox4x32-10 in plain PyTorch: the dropout masks of the port's kernels.

A counter-based generator: the bits of an element are a pure function of
(seed, stream, element index), so a CUDA kernel draws a mask element where
it needs it, a backward kernel draws it again instead of storing it, and
the plain PyTorch version of the kernel draws the same bits here.
`csrc/philox.cuh` is the CUDA twin; the two agree bit for bit.

Layout of one draw: counter (e >> 2, a, b, 0), key (seed, 0), output word
e & 3, where (a, b) is the stream and e the element index within it:

  encoder layer   a = batch row, b = site (0..H-1 the attention weights of
                  each head [L, L], H the attention output [L, D], H+1 after
                  the ReLU [L, F], H+2 the FFN output [L, D]), e row-major
                  within the site's [L, *] block
  temporal layer  a = batch row, b = site (0..H-1 the attention weights of
                  each head [L, L], H after the GELU [L, F], H+1 the FFN
                  output [L, D]; no dropout on the attention output), e
                  row-major within the site's [L, *] block
  X-Pool          a = music m, b = video v, e = channel d

Keep when bits >= threshold(rate), scale kept values by 1 / (1 - rate):
torch's inverted dropout, with P(keep) = 1 - threshold / 2^32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Random123's Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # key bumps (golden ratio, sqrt(3) - 1)
_MASK = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The uint32 below which a draw is dropped."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_scale(rate: float) -> float:
    """The value a kept element is multiplied by, as float32 holds it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def seed_tensor(seed: int, device: torch.device) -> torch.Tensor:
    """A new one-element int32 tensor on `device` holding the bits of the
    uint32 `seed`, made by a fill (no wait for the device)."""
    word = int(seed) & _MASK
    return torch.full((1,), word - (1 << 32) if word >> 31 else word, dtype=torch.int32,
                      device=device)


def device_seed(seed: Union[int, torch.Tensor], rate: float,
                device: torch.device) -> Optional[torch.Tensor]:
    """A kernel call's seed as the kernels read it, from device memory: None
    at rate 0 (no mask is drawn), `seed` itself when it is a tensor already
    (a slot of the step's seed buffer, models/layers.py::StepSeeds), else
    `seed_tensor(seed)`."""
    if rate == 0.0:
        return None
    return seed if isinstance(seed, torch.Tensor) else seed_tensor(seed, device)


def kernel_args(rate: float, seed: Optional[torch.Tensor]) -> Tuple[int, int, float]:
    """(seed pointer, threshold, keep scale) as a kernel's `Dropout` struct
    takes them (csrc/philox.cuh), `seed` a `device_seed`; threshold 0 turns
    dropout off and the pointer is then null."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return 0, 0, 1.0
    return seed.data_ptr(), threshold(rate), keep_scale(rate)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * m for a in [0, 2^32), in int64 without
    overflow: a * m = (a * m_hi) 2^16 + a * m_lo with both products < 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    low = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (low >> 32)) & _MASK, low & _MASK


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
    return c0, c1, c2, c3


def bits(seed: Union[int, torch.Tensor], a: torch.Tensor, b: torch.Tensor,
         n: int) -> torch.Tensor:
    """uint32 draws (as int64) of elements 0..n-1 of streams (a, b).

    a and b are int64 tensors that broadcast to the streams' shape S; the
    result has shape S + (n,).  `seed` may be a one-element tensor on a's
    device (a `device_seed`), read there without a wait for the device."""
    a, b = torch.broadcast_tensors(a, b)
    key = (seed.reshape(()).to(torch.int64) & _MASK if isinstance(seed, torch.Tensor)
           else int(seed) & _MASK)
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=a.device)
    shape = a.shape + (1,)
    c0 = j.expand(*a.shape, j.numel())
    c1 = a.reshape(shape).expand_as(c0)
    c2 = b.reshape(shape).expand_as(c0)
    words = philox4x32(c0, c1, c2, torch.zeros_like(c0), key, 0)
    return torch.stack(words, dim=-1).reshape(*a.shape, -1)[..., :n]


def keep_mask(seed: int, a: torch.Tensor, b: torch.Tensor, n: int,
              rate: float) -> torch.Tensor:
    """Float32 inverted-dropout mask (0 or 1 / (1 - rate)) of shape
    broadcast(a, b).shape + (n,)."""
    keep = bits(seed, a, b, n) >= threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


def encoder_masks(seed: int, batch: int, length: int, dim: int, ffn: int,
                  heads: int, rate: float, device=None) -> dict:
    """The four dropout masks of one encoder layer call, keyed as the JAX
    package's `jax_dropout_masks`: attn [B, H, L, L], attn_out [B, L, D],
    ffn1 [B, L, F], ffn2 [B, L, D]."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    site = lambda s: torch.full((1, 1), s, dtype=torch.int64, device=device)
    heads_ = torch.arange(heads, dtype=torch.int64, device=device)[None, :]
    return {
        "attn": keep_mask(seed, rows, heads_, length * length, rate).reshape(
            batch, heads, length, length),
        "attn_out": keep_mask(seed, rows[:, 0], site(heads)[0], length * dim,
                              rate).reshape(batch, length, dim),
        "ffn1": keep_mask(seed, rows[:, 0], site(heads + 1)[0], length * ffn,
                          rate).reshape(batch, length, ffn),
        "ffn2": keep_mask(seed, rows[:, 0], site(heads + 2)[0], length * dim,
                          rate).reshape(batch, length, dim),
    }


def temporal_masks(seed: int, batch: int, length: int, dim: int, ffn: int,
                   heads: int, rate: float, device=None) -> dict:
    """The three dropout masks of one temporal-layer call, keyed as the JAX
    package's `jax_temporal_dropout_masks`: attn [B, H, L, L], ffn1
    [B, L, F], ffn2 [B, L, D]."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)
    site = lambda s: torch.tensor([s], dtype=torch.int64, device=device)
    heads_ = torch.arange(heads, dtype=torch.int64, device=device)[None, :]
    return {
        "attn": keep_mask(seed, rows[:, None], heads_, length * length, rate).reshape(
            batch, heads, length, length),
        "ffn1": keep_mask(seed, rows, site(heads), length * ffn, rate).reshape(
            batch, length, ffn),
        "ffn2": keep_mask(seed, rows, site(heads + 1), length * dim, rate).reshape(
            batch, length, dim),
    }


def xpool_mask(seed: int, musics: int, videos: int, dim: int, rate: float,
               device=None) -> torch.Tensor:
    """The X-Pool linear-branch dropout mask [M, V, D]."""
    m = torch.arange(musics, dtype=torch.int64, device=device)[:, None]
    v = torch.arange(videos, dtype=torch.int64, device=device)[None, :]
    return keep_mask(seed, m, v, dim, rate)
