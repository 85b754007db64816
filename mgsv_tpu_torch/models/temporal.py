"""Temporal "enhancement" transformer, ported from mgsv_tpu/models/temporal.py.

Keeps the reference's residual placement, taken after norm1:

    x = norm1(x); x = attn(x, x, x) + x; x = norm2(x); x = ff(x) + x
    return final_linear(x)

Parameter names follow the reference Transformer_enhancement:
`layers.{i}.{0: norm1, 1: attn, 2: norm2, 3: ff}` with the FFN a Sequential
whose Linear layers sit at indices 0 and 3 and whose dropout sites sit at 2
and 4.  Dropout (0.8 in the paper configuration) hits the attention weights
and those two sites, with masks from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mgsv_tpu_torch.models.layers import Dropout, MultiHeadAttention, lecun_normal_, widen


class TemporalTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 out_dim: int, compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0):
        super().__init__()
        # compute_dtype (bf16) runs the layers under autocast; final_linear
        # stays float32, as in the JAX module
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            nn.ModuleList([
                nn.LayerNorm(dim, eps=1e-5),
                MultiHeadAttention(dim, heads, dropout),
                nn.LayerNorm(dim, eps=1e-5),
                nn.Sequential(nn.Linear(dim, mlp_dim), nn.GELU(), Dropout(dropout),
                              nn.Linear(mlp_dim, dim), Dropout(dropout)),
            ]) for _ in range(depth))
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
        """x [B, L, D], mask [B, L] (1 = valid) -> [B, L, out_dim]; dropout
        only with a generator."""
        with torch.autocast(x.device.type, dtype=self.compute_dtype or torch.bfloat16,
                            enabled=self.compute_dtype is not None):
            for norm1, attn, norm2, ff in self.layers:
                x = norm1(x)
                x = attn(x, x, x, key_mask=mask, generator=generator) + x
                x = norm2(x)
                h = ff[2](ff[1](ff[0](x)), generator)
                x = ff[4](ff[3](h), generator) + x
        return self.final_linear(widen(x))
