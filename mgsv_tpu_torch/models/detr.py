"""DETR transformer for music-moment detection, ported from
mgsv_tpu/models/detr.py: post-norm layers (the shipped configuration) and
pre-norm ones (`detr_pre_norm`).

Batch-major [B, L, D] throughout.  Parameter names follow the reference
(`encoder.layers.{i}`, `decoder.layers.{i}`, `decoder.norm`, and in
pre-norm `encoder.norm`).  In post-norm the encoder has no final
LayerNorm; every decoder layer's output goes through the shared
`decoder.norm` (return_intermediate).  A pre-norm decoder layer always has
its self-attention and norm1, as JAX's.

Dropout (rate `dropout` of each layer, 0.1 in the paper configuration) sits
where the JAX layers have it: the attention weights, the attention output,
after the FFN's ReLU and after the FFN.  Each post-norm encoder layer runs
through the encoder-layer kernel's autograd Function
(ops/cuda/fused_encoder_layer.py: forward kernel, backward kernel; its
plain version on CPU tensors), in training and in serving, in float32
outside autocast, at the precision the caller names ("bf16" under a bf16
model, as JAX's FusedDetrEncoderLayer), with its four Philox masks keyed on
one int seed per layer call drawn from the step's generator.  With
`plain=True` (JAX's fused_detr_encoder=False, and the serving engine
without kernels), and always in pre-norm (JAX's kernel layer is post-norm
only: `use_fused_enc = fused_encoder and not pre_norm`), the plain layers
run under the caller's autocast, their masks drawn from that
`torch.Generator`, as the decoder's are.  With `fused_decoder=True` each
post-norm decoder layer runs through the decoder-layer kernel's autograd
Function (ops/cuda/fused_decoder_layer.py) in float32, as JAX's
FusedDetrDecoderLayer: it has no dropout; a pre-norm decoder refuses it.
Without a generator every layer is deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.models.layers import (MultiHeadAttention, draw_seed, dropout, widen,
                                          xavier_uniform_)
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel

def _xavier_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    xavier_uniform_(lin.weight, generator)
    nn.init.zeros_(lin.bias)


class DetrEncoderLayer(nn.Module):
    """Post-norm (or pre-norm) encoder layer: q, k from src + pos, v from
    src (from norm1(src) in pre-norm)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, pre_norm: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(dim, heads, dropout)
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

    def forward(self, src: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                masks: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The plain layer.  masks: the four multiplicative dropout masks
        ("attn" [B, H, L, L], "attn_out" [B, L, D], "ffn1" [B, L, F],
        "ffn2" [B, L, D]), as the JAX package's layer_fwd_with_masks takes
        them; without masks, dropout at the layer's rate drawn from
        `generator`; neither: no dropout."""
        masks = masks or {}

        def site(t, name):
            return t * masks[name] if name in masks else dropout(t, self.dropout, generator)

        if self.pre_norm:
            src2 = self.norm1(src)
            qk = src2 + pos
            src = src + site(self.self_attn(qk, qk, src2, key_mask=mask, generator=generator,
                                            attn_mask=masks.get("attn")), "attn_out")
            h = site(F.relu(self.linear1(self.norm2(src))), "ffn1")
            return src + site(self.linear2(h), "ffn2")
        qk = src + pos
        attn = self.self_attn(qk, qk, src, key_mask=mask, generator=generator,
                              attn_mask=masks.get("attn"))
        src = self.norm1(src + site(attn, "attn_out"))
        h = site(F.relu(self.linear1(src)), "ffn1")
        return self.norm2(src + site(self.linear2(h), "ffn2"))


class DetrDecoderLayer(nn.Module):
    """Post-norm decoder layer with optional self-attention over queries,
    or pre-norm with it always.  Cross-attention: q from tgt + query_pos, k
    from memory + pos, v from memory."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 self_attn: bool = True, pre_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        if self_attn or pre_norm:
            self.self_attn = MultiHeadAttention(dim, heads, dropout)
            self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        else:
            self.self_attn = None
        self.multihead_attn = MultiHeadAttention(dim, heads, dropout)
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

    def forward(self, tgt, memory, mem_mask, pos, query_pos,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout, generator)
        ffn = lambda t: self.linear2(drop(F.relu(self.linear1(t))))
        if self.pre_norm:
            tgt2 = self.norm1(tgt)
            qk = tgt2 + query_pos
            tgt = tgt + drop(self.self_attn(qk, qk, tgt2, generator=generator))
            tgt2 = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(tgt2 + query_pos, memory + pos, memory,
                                                 key_mask=mem_mask, generator=generator))
            return tgt + drop(ffn(self.norm3(tgt)))
        if self.self_attn is not None:
            qk = tgt + query_pos
            tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt, generator=generator)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            tgt + query_pos, memory + pos, memory, key_mask=mem_mask, generator=generator)))
        return self.norm3(tgt + drop(ffn(tgt)))


class DetrEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, num_layers: int,
                 dropout: float = 0.0, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.layers = nn.ModuleList(
            DetrEncoderLayer(dim, heads, ffn_dim, pre_norm, dropout) for _ in range(num_layers))
        # the pre-norm encoder's final LayerNorm (JAX's encoder_norm)
        self.norm = nn.LayerNorm(dim, eps=1e-5) if pre_norm and num_layers > 0 else None

    def forward(self, src, mask, pos, generator: Optional[torch.Generator] = None,
                plain: bool = False, precision: str = "f32") -> torch.Tensor:
        """Each layer through the kernel's wrapper at `precision`, in
        float32 outside autocast (`plain`, and always in pre-norm: the
        plain layers under the caller's autocast, JAX's
        fused_detr_encoder=False); dropout at the layer's rate only with a
        generator."""
        if plain or self.pre_norm:
            for layer in self.layers:
                src = layer(src, mask, pos, generator=generator)
            return src if self.norm is None else self.norm(src)
        src, mask, pos = widen(src), widen(mask), widen(pos)
        with torch.autocast(src.device.type, enabled=False):
            for layer in self.layers:
                rate = layer.dropout if generator is not None else 0.0
                seed = draw_seed(generator) if rate > 0.0 else 0
                src = fel.fused_encoder_layer(src, mask, pos, layer, rate, seed, precision)
        return src


class DetrDecoder(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, num_layers: int,
                 self_attn: bool, dropout: float = 0.0, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.layers = nn.ModuleList(
            DetrDecoderLayer(dim, heads, ffn_dim, self_attn, pre_norm, dropout)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory, mem_mask, pos, query_pos,
                generator=None, fused: bool = False) -> torch.Tensor:
        """-> [num_layers, B, Q, D], each layer's output through `norm`.
        `fused`: each layer through the decoder-layer kernel's wrapper, in
        float32 outside autocast and without dropout (the caller refuses a
        training call with a dropout rate); post-norm only, as JAX's fused
        decoder layer."""
        intermediate = []
        if fused and self.pre_norm:
            raise ValueError("fused_decoder=True runs the post-norm decoder layer only; "
                             "model.detr_pre_norm=True needs the plain decoder")
        if fused:
            tgt, memory, mem_mask, pos, query_pos = map(widen, (tgt, memory, mem_mask, pos,
                                                                query_pos))
            with torch.autocast(tgt.device.type, enabled=False):
                for layer in self.layers:
                    tgt = fdl.fused_decoder_layer(tgt, memory, mem_mask, pos, query_pos, layer)
                    intermediate.append(self.norm(tgt))
            return torch.stack(intermediate, dim=0)
        for layer in self.layers:
            tgt = layer(tgt, memory, mem_mask, pos, query_pos, generator)
            intermediate.append(self.norm(widen(tgt)))
        return torch.stack(intermediate, dim=0)


class DetrTransformer(nn.Module):
    """forward(src [B, L, D], mask [B, L], pos [B, L, D], query_embed [Q, D],
    target [B, Q, D] | None) -> (hidden [dec_layers, B, Q, D], memory)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, enc_layers: int,
                 dec_layers: int, decoder_self_attn: bool = True,
                 pre_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.encoder = DetrEncoder(dim, heads, ffn_dim, enc_layers, dropout, pre_norm)
        self.decoder = DetrDecoder(dim, heads, ffn_dim, dec_layers, decoder_self_attn, dropout,
                                   pre_norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (*self.encoder.layers, *self.decoder.layers):
            layer.reset_parameters(generator)
        if self.encoder.norm is not None:
            self.encoder.norm.reset_parameters()
        self.decoder.norm.reset_parameters()

    def forward(self, src, mask, pos, query_embed,
                target: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, plain: bool = False,
                precision: str = "f32", fused_decoder: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`plain` and `precision` pick the encoder's route (DetrEncoder),
        `fused_decoder` the decoder's (DetrDecoder, which refuses it in
        pre-norm)."""
        memory = self.encoder(src, mask, pos, generator, plain, precision)
        return self.decode(memory, mask, pos, query_embed, target, generator,
                           fused_decoder), memory

    def decode(self, memory, mask, pos, query_embed,
               target: Optional[torch.Tensor],
               generator: Optional[torch.Generator] = None,
               fused_decoder: bool = False) -> torch.Tensor:
        query_pos = query_embed[None].expand(memory.shape[0], *query_embed.shape)
        tgt = torch.zeros_like(query_pos) if target is None else target
        return self.decoder(tgt, memory, mask, pos, query_pos, generator, fused_decoder)
