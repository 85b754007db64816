"""Shared ViT block of the frozen towers, ported from
mgsv_tpu/models/vit_common.py.

Both frozen encoders are 12-layer pre-norm ViTs: the AST (timm's DeiT) with
exact-erf GELU and CLIP ViT-B/32 with QuickGELU.  One block serves both;
its parameters carry timm's names (norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2), so an AST checkpoint loads as it is and CLIP's are
renamed on loading (models/clip_vit.py).  Attention is injectable: the
towers pass their `attention_fn` to every block, `default_attention` or
`ops/cuda/flash_attention.py::make_attention_fn()` (the kernel for long
key sequences).  Parameters stay float32; `dtype` is the compute dtype of
the matrix products, and the LayerNorms compute in float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.models.layers import quick_gelu

LN_EPS = 1e-5


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """[B, H, L, Dh] full attention: einsum, softmax over keys, einsum."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """layer(x) with input and parameters cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """norm(x) computed in float32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class ViTSelfAttention(nn.Module):
    """Packed-qkv multi-head self-attention (timm / CLIP packing: q | k | v
    rows of one [3D, D] weight)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                attention_fn: Callable = default_attention) -> torch.Tensor:
        b, length, _ = x.shape
        head_dim = self.dim // self.heads
        qkv = linear(x, self.qkv, self.dtype).reshape(b, length, 3, self.heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                  # each [B, H, L, Dh]
        # 1 / sqrt(Dh) in float32, as the JAX block computes it
        scale = float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))
        out = attention_fn(q, k, v, scale)
        out = out.transpose(1, 2).reshape(b, length, self.dim)
        return linear(out, self.proj, self.dtype)


class ViTMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm transformer block: x + attn(norm1(x)); x + mlp(norm2(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, act: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"ViTBlock: act {act!r} (gelu for timm/AST, quick_gelu for CLIP)")
        self.act, self.dtype = act, dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTSelfAttention(dim, heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor,
                attention_fn: Callable = default_attention) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1).to(self.dtype), attention_fn)
        h = linear(layer_norm(x, self.norm2), self.mlp.fc1, self.dtype)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)   # exact erf GELU
        return x + linear(h, self.mlp.fc2, self.dtype)
