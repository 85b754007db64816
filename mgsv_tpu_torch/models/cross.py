"""Masked cross-attention transformer (the "CA" detection fusion), ported
from mgsv_tpu/models/cross.py.

With `mml_fusion="CA"` the music snippet tokens attend to the video frame
tokens before moment detection.  Masking as in the JAX module:

  * kv_mask: masked keys' logits set to BIG_NEG (-1e9) before the softmax;
  * q_mask: the attention rows of masked queries zeroed after the softmax.

Parameter names follow the reference CrossTransformer
(`attention_query_layer_norms.{i}`, `attention_context_layer_norms.{i}`,
`ff_layer_norms.{i}`, `layers.{i}.0` the attention with `to_q`, `to_kv`
and `to_out.0`, `layers.{i}.1` the FeedForward, `final_linear`).  It runs
in float32 whatever the model's compute dtype, as JAX's module (which takes
no dtype) does; dropout (0.8 in the configuration) on `to_out` and on both
FeedForward outputs, drawn from the caller's generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mgsv_tpu_torch.models.layers import (BIG_NEG, Dropout, FeedForward, lecun_normal_,
                                          xavier_normal_)


class CrossAttention(nn.Module):
    """Multi-head cross-attention without biases on q and kv; `to_out`
    (Linear, dropout) exists unless one head spans the whole width."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim), Dropout(dropout))
                       if project_out else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_normal_(self.to_q.weight, generator)
        xavier_normal_(self.to_kv.weight, generator)
        if self.to_out is not None:
            xavier_normal_(self.to_out[0].weight, generator)
            nn.init.constant_(self.to_out[0].bias, 0.01)

    def forward(self, query: torch.Tensor, context: torch.Tensor,
                q_mask: Optional[torch.Tensor] = None, kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query [B, Lq, D], context [B, Lk, D], masks [B, L] (1 = valid)
        -> (out [B, Lq, D], attention [B, H, Lq, Lk])."""
        b, lq, _ = query.shape
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        q = split(self.to_q(query))
        k, v = (split(t) for t in self.to_kv(context).chunk(2, dim=-1))
        dots = (q @ k.transpose(-1, -2)) * (self.dim_head ** -0.5)
        if kv_mask is not None:
            dots = torch.where(kv_mask[:, None, None, :] != 0, dots,
                               torch.full_like(dots, BIG_NEG))
        attn = torch.softmax(dots, dim=-1)
        if q_mask is not None:
            attn = attn * (q_mask[:, None, :, None] != 0).to(attn.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, lq, self.heads * self.dim_head)
        if self.to_out is not None:
            out = self.to_out[1](self.to_out[0](out), generator)
        return out, attn


class CrossTransformer(nn.Module):
    """Pre-LayerNorm cross-attention and FeedForward blocks, then a Linear."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8, dim_head: int = 128,
                 mlp_dim: int = 1024, out_dim: int = 256, dropout: float = 0.8):
        super().__init__()
        norms = lambda: nn.ModuleList(nn.LayerNorm(dim, eps=1e-5) for _ in range(depth))
        self.attention_query_layer_norms = norms()
        self.attention_context_layer_norms = norms()
        self.ff_layer_norms = norms()
        self.layers = nn.ModuleList(
            nn.ModuleList([CrossAttention(dim, heads, dim_head, dropout),
                           FeedForward(dim, mlp_dim, dim, dropout)]) for _ in range(depth))
        self.final_linear = nn.Linear(dim, out_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's initializers: xavier-normal attention and FeedForward,
        lecun-normal final_linear, unit LayerNorms."""
        for attn, ff in self.layers:
            attn.reset_parameters(generator)
            ff.reset_parameters(generator)
        for ln in (*self.attention_query_layer_norms, *self.attention_context_layer_norms,
                   *self.ff_layer_norms):
            ln.reset_parameters()
        lecun_normal_(self.final_linear.weight, generator)
        nn.init.zeros_(self.final_linear.bias)

    def forward(self, query: torch.Tensor, context: torch.Tensor,
                q_mask: Optional[torch.Tensor] = None, kv_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (final_linear(x) [B, Lq, out_dim], the last block's attention)."""
        x, last_attn = query, None
        for qn, cn, fn, (attn, ff) in zip(self.attention_query_layer_norms,
                                          self.attention_context_layer_norms,
                                          self.ff_layer_norms, self.layers):
            x_res, last_attn = attn(qn(x), cn(context), q_mask, kv_mask, generator)
            attn_x = x_res + x
            x = ff(fn(attn_x), generator) + attn_x
        return self.final_linear(x), last_attn
