"""DETR transformer for music-moment detection, ported from
mgsv_tpu/models/detr.py (post-norm layers, the shipped configuration).

Batch-major [B, L, D] throughout.  Parameter names follow the reference
(`encoder.layers.{i}`, `decoder.layers.{i}`, `decoder.norm`).  The encoder
has no final LayerNorm in post-norm, and every decoder layer's output goes
through the shared `decoder.norm` (return_intermediate).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.models.layers import MultiHeadAttention, xavier_uniform_

_PRE_NORM_MSG = ("pre-norm DETR layers are not ported yet "
                 "(ROADMAP.md, queue 1: variant matrix)")


def _xavier_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    xavier_uniform_(lin.weight, generator)
    nn.init.zeros_(lin.bias)


class DetrEncoderLayer(nn.Module):
    """Post-norm encoder layer: q, k from src + pos, v from src."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, pre_norm: bool = False):
        super().__init__()
        if pre_norm:
            raise NotImplementedError(_PRE_NORM_MSG)
        self.self_attn = MultiHeadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.self_attn.reset_parameters(generator)
        _xavier_linear_(self.linear1, generator)
        _xavier_linear_(self.linear2, generator)
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()

    def forward(self, src: torch.Tensor, mask: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, key_mask=mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DetrDecoderLayer(nn.Module):
    """Post-norm decoder layer with optional self-attention over queries.
    Cross-attention: q from tgt + query_pos, k from memory + pos, v from
    memory."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 self_attn: bool = True, pre_norm: bool = False):
        super().__init__()
        if pre_norm:
            raise NotImplementedError(_PRE_NORM_MSG)
        if self_attn:
            self.self_attn = MultiHeadAttention(dim, heads)
            self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        else:
            self.self_attn = None
        self.multihead_attn = MultiHeadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.self_attn is not None:
            self.self_attn.reset_parameters(generator)
            self.norm1.reset_parameters()
        self.multihead_attn.reset_parameters(generator)
        _xavier_linear_(self.linear1, generator)
        _xavier_linear_(self.linear2, generator)
        self.norm2.reset_parameters()
        self.norm3.reset_parameters()

    def forward(self, tgt, memory, mem_mask, pos, query_pos) -> torch.Tensor:
        if self.self_attn is not None:
            qk = tgt + query_pos
            tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(
            tgt + query_pos, memory + pos, memory, key_mask=mem_mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DetrEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DetrEncoderLayer(dim, heads, ffn_dim) for _ in range(num_layers))

    def forward(self, src, mask, pos) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, mask, pos)
        return src


class DetrDecoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, num_layers: int,
                 self_attn: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            DetrDecoderLayer(dim, heads, ffn_dim, self_attn=self_attn)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory, mem_mask, pos, query_pos) -> torch.Tensor:
        """-> [num_layers, B, Q, D], each layer's output through `norm`."""
        intermediate = []
        for layer in self.layers:
            tgt = layer(tgt, memory, mem_mask, pos, query_pos)
            intermediate.append(self.norm(tgt.float()))
        return torch.stack(intermediate, dim=0)


class DetrTransformer(nn.Module):
    """forward(src [B, L, D], mask [B, L], pos [B, L, D], query_embed [Q, D],
    target [B, Q, D] | None) -> (hidden [dec_layers, B, Q, D], memory)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, enc_layers: int,
                 dec_layers: int, decoder_self_attn: bool = True,
                 pre_norm: bool = False):
        super().__init__()
        if pre_norm:
            raise NotImplementedError(_PRE_NORM_MSG)
        self.encoder = DetrEncoder(dim, heads, ffn_dim, enc_layers)
        self.decoder = DetrDecoder(dim, heads, ffn_dim, dec_layers, decoder_self_attn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (*self.encoder.layers, *self.decoder.layers):
            layer.reset_parameters(generator)
        self.decoder.norm.reset_parameters()

    def forward(self, src, mask, pos, query_embed,
                target: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        memory = self.encoder(src, mask, pos)
        return self.decode(memory, mask, pos, query_embed, target), memory

    def decode(self, memory, mask, pos, query_embed,
               target: Optional[torch.Tensor]) -> torch.Tensor:
        query_pos = query_embed[None].expand(memory.shape[0], *query_embed.shape)
        tgt = torch.zeros_like(query_pos) if target is None else target
        return self.decoder(tgt, memory, mask, pos, query_pos)
