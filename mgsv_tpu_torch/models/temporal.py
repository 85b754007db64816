"""Temporal "enhancement" transformer, ported from mgsv_tpu/models/temporal.py.

Keeps the reference's residual placement, taken after norm1:

    x = norm1(x); x = attn(x, x, x) + x; x = norm2(x); x = ff(x) + x
    return final_linear(x)

Parameter names follow the reference Transformer_enhancement:
`layers.{i}.{0: norm1, 1: attn, 2: norm2, 3: ff}` with the FFN a Sequential
whose Linear layers sit at indices 0 and 3 and whose dropout sites sit at 2
and 4.  Dropout (0.8 in the paper configuration) hits the attention weights
and those two sites, with masks from an explicit `torch.Generator`, or
(`TemporalLayer`) from explicit masks.

`FusedTemporalTransformer` is the twin of the JAX module of that name
(`Config.model.fused_temporal`): the same parameters, each layer on the
fused temporal-layer kernel (ops/cuda/fused_temporal_layer.py) in float32,
with one Philox seed per layer drawn from the generator.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from mgsv_tpu_torch.models.layers import (Dropout, MultiHeadAttention, draw_seed,
                                          lecun_normal_, widen)
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl


class TemporalLayer(nn.ModuleList):
    """One layer, [norm1, attn, norm2, ff] (the reference's ModuleList)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, dropout: float):
        super().__init__([
            nn.LayerNorm(dim, eps=1e-5),
            MultiHeadAttention(dim, heads, dropout),
            nn.LayerNorm(dim, eps=1e-5),
            nn.Sequential(nn.Linear(dim, mlp_dim), nn.GELU(), Dropout(dropout),
                          nn.Linear(mlp_dim, dim), Dropout(dropout)),
        ])

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                masks: Optional[dict] = None) -> torch.Tensor:
        """y = LN1(x); u = y + MHA(y); z = LN2(u); z + drop(fc2(drop(gelu(fc1 z)))).
        Dropout from `generator`, or the multiplicative `masks` ("attn"
        [B, H, L, L], "ffn1" [B, L, F], "ffn2" [B, L, D]) as the JAX
        package's temporal_layer_fwd_with_masks takes them."""
        norm1, attn, norm2, ff = self
        masks = masks or {}
        drop = lambda t, name, module: t * masks[name] if name in masks else module(t, generator)
        y = norm1(x)
        u = attn(y, y, y, key_mask=mask, generator=generator, attn_mask=masks.get("attn")) + y
        z = norm2(u)
        h = drop(ff[1](ff[0](z)), "ffn1", ff[2])
        return drop(ff[3](h), "ffn2", ff[4]) + z


class TemporalTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 out_dim: int, compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0):
        super().__init__()
        # compute_dtype (bf16) runs the layers under autocast; final_linear
        # stays float32, as in the JAX module
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.layers = nn.ModuleList(
            TemporalLayer(dim, heads, mlp_dim, dropout) for _ in range(depth))
        self.final_linear = nn.Linear(dim, out_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for norm1, attn, norm2, ff in self.layers:
            norm1.reset_parameters()
            attn.reset_parameters(generator)
            norm2.reset_parameters()
            for lin in (ff[0], ff[3]):
                lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
        lecun_normal_(self.final_linear.weight, generator)
        nn.init.zeros_(self.final_linear.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The plain PyTorch layers under the compute dtype's autocast.
        x [B, L, D], mask [B, L] (1 = valid) -> [B, L, out_dim]; dropout
        only with a generator."""
        with torch.autocast(x.device.type, dtype=self.compute_dtype or torch.bfloat16,
                            enabled=self.compute_dtype is not None):
            for layer in self.layers:
                x = layer(x, mask, generator)
        return self.final_linear(widen(x))

    # the plain layers, also on a FusedTemporalTransformer (which overrides forward)
    plain_forward = forward


class FusedTemporalTransformer(TemporalTransformer):
    """TemporalTransformer twin whose layers run on the fused temporal-layer
    kernel, forward and backward, in float32 (the JAX module's numerics: it
    too ignores a bf16 compute dtype, with a warning).  Same parameters,
    same initialization; `plain_forward` runs the plain layers on them."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 out_dim: int, compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0):
        super().__init__(dim, depth, heads, mlp_dim, out_dim, compute_dtype, dropout)
        if compute_dtype not in (None, torch.float32):
            warnings.warn(f"FusedTemporalTransformer ignores compute dtype {compute_dtype}: "
                          "its layers run in float32", stacklevel=2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """As TemporalTransformer.forward, each layer through
        `fused_temporal_layer` outside autocast: dropout at the configured
        rate with one Philox seed per layer drawn from `generator`, none
        without one."""
        rate = self.dropout if generator is not None else 0.0
        x = widen(x)
        with torch.autocast(x.device.type, enabled=False):
            for layer in self.layers:
                seed = draw_seed(generator) if rate > 0.0 else 0
                x = ftl.fused_temporal_layer(x, mask, layer, rate, seed)
            return self.final_linear(x)
