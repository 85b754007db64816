"""Shared building blocks, ported from mgsv_tpu/models/layers.py.

Same conventions as the JAX package: masks are float/bool [B, L] with
1 = valid token, and masked attention logits are replaced by BIG_NEG (not
-inf), so a fully masked row gives a uniform softmax instead of NaN.  That
is also why attention is written out here rather than taken from
torch.nn.MultiheadAttention, which masks with -inf.

Initializers take an explicit torch.Generator and follow the flax ones of
the JAX package (xavier-uniform for attention and DETR, lecun-normal for
plain Dense layers, xavier-normal for the CA fusion's cross-attention).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BIG_NEG = -1e9


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax xavier_uniform on a torch [out, in] weight."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax lecun_normal (the nn.Dense default): a normal truncated at two
    standard deviations, rescaled to variance 1/fan_in."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax xavier_normal on a torch [out, in] weight: a normal truncated at
    two standard deviations, rescaled to variance 2 / (fan_in + fan_out)."""
    fan_out, fan_in = w.shape
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def sinusoidal_table(seq_len: int, dim: int) -> np.ndarray:
    """Fixed sin/cos table [seq_len, dim], computed in numpy as the JAX
    package does (whose module imports flax, so it is not imported here)."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch's inverted dropout with its mask drawn from `generator` (never
    the global RNG); the identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class Dropout(nn.Module):
    """`dropout` as a parameter-free module (it holds a place in a
    Sequential's state-dict numbering)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, generator)


def draw_seed(generator: torch.Generator) -> int:
    """One int seed for a kernel's Philox masks per call (as the JAX package
    draws an int32 seed from its dropout rng per call).  The kernels take
    the seed as a host int.  A CPU generator draws it; a CUDA generator's
    draw would make the host wait for the device, so the seed is derived on
    the host from the generator's seed and Philox offset (host state), and
    the offset steps on as a draw would."""
    if generator.device.type == "cpu":
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
    offset = generator.get_offset()
    generator.set_offset(offset + 4)
    key = np.random.SeedSequence([generator.initial_seed(), offset])
    return int(key.generate_state(1)[0] & 0x7FFFFFFF)


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> float32; float32 and float64 unchanged (so a float64 run
    of the plain modules stays float64)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def pad_fused_sequence(fused: torch.Tensor, mask: torch.Tensor, multiple: int):
    """Pad [B, L, D] (+ its [B, L] mask) with mask-zero tokens up to a
    multiple of `multiple` tokens; multiple <= 1 disables.  Valid tokens'
    math is unchanged: pads are masked out of every softmax."""
    extra = (-fused.shape[1]) % multiple if multiple > 1 else 0
    if extra:
        fused = F.pad(fused, (0, 0, 0, extra))
        mask = F.pad(mask, (0, extra))
    return fused, mask


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """DETR sine embedding over the cumulative valid-token rank, normalized
    to [0, 2*pi].  mask [B, L] (1 = valid) -> [B, L, num_pos_feats], with
    sin and cos interleaved along the last axis."""
    x_embed = torch.cumsum(mask.float(), dim=1)
    x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos = x_embed[:, :, None] / dim_t
    pos = torch.stack([pos[:, :, 0::2].sin(), pos[:, :, 1::2].cos()], dim=3)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the sequence axis of the valid tokens: [B, L, D] -> [B, D].
    Callers guarantee at least one valid token per row."""
    mask = mask.to(x.dtype)
    return (x * mask[..., None]).sum(dim=1) / mask.sum(dim=1, keepdim=True)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), eps^2)), the JAX package's form."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class FeedForward(nn.Module):
    """Linear, exact GELU, dropout, Linear, dropout (the JAX FeedForward);
    parameters `net.0` and `net.3`, as the reference's Sequential."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(), Dropout(dropout),
                                 nn.Linear(hidden_dim, out_dim), Dropout(dropout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """xavier-normal weights, biases 0.01, as in JAX."""
        for lin in (self.net[0], self.net[3]):
            xavier_normal_(lin.weight, generator)
            nn.init.constant_(lin.bias, 0.01)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fc1, gelu, drop1, fc2, drop2 = self.net
        return drop2(fc2(drop1(gelu(fc1(x)), generator)), generator)


class DetrMLP(nn.Module):
    """ReLU MLP head; parameters `layers.{i}` as in the reference."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in self.layers:
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Masked multi-head attention with torch nn.MultiheadAttention's
    packed parameters (`in_proj_weight` rows q|k|v, `in_proj_bias`,
    `out_proj`), so reference state dicts load by name.

    forward(query, key, value, key_mask) covers the self (q = k = v),
    q = k (DETR: pos added to queries and keys, not values) and cross forms.
    Dropout at `dropout` applies to the attention weights, as torch does:
    from `generator`, or the explicit multiplicative `attn_mask`
    [B, H, Lq, Lk] when one is given.
    """

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.dim, self.heads, self.dropout = dim, heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax initializes q, k and v as three [D, D] kernels
        for w in self.in_proj_weight.data.chunk(3, dim=0):
            xavier_uniform_(w, generator)
        nn.init.zeros_(self.in_proj_bias)
        xavier_uniform_(self.out_proj.weight, generator)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Lq, D], key/value [B, Lk, D], key_mask [B, Lk] -> [B, Lq, D]."""
        wq, wk, wv = self.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3, dim=0)
        b, lq, d = query.shape
        dh = d // self.heads
        split = lambda t: t.reshape(b, t.shape[1], self.heads, dh).transpose(1, 2)
        q = split(F.linear(query, wq, bq))
        k = split(F.linear(key, wk, bk))
        v = split(F.linear(value, wv, bv))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh)       # [B, H, Lq, Lk]
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :] != 0, logits,
                                 torch.full_like(logits, BIG_NEG))
        attn = torch.softmax(widen(logits), dim=-1).to(v.dtype)
        if attn_mask is not None:
            attn = attn * attn_mask.to(attn.dtype)
        else:
            attn = dropout(attn, self.dropout, generator)
        out = (attn @ v).transpose(1, 2).reshape(b, lq, d)
        return self.out_proj(out)
