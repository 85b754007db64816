"""DETR forward with the encoder layers on the fused kernel, ported from
mgsv_tpu/ops/pallas/detr_fused.py (deterministic serving path).

The encoder layers run through ops/cuda/fused_encoder_layer.py; the decoder
layers run as the plain modules (at one moment query they cost little).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mgsv_tpu_torch.models.detr import DetrTransformer
from mgsv_tpu_torch.ops.cuda.fused_encoder_layer import fused_encoder_layer


def detr_forward_fused(
    detr: DetrTransformer,
    src: torch.Tensor,                 # [B, L, D] float32
    mask: torch.Tensor,                # [B, L] float32, 1 = valid
    pos: torch.Tensor,                 # [B, L, D] float32
    query_embed: torch.Tensor,         # [Q, D]
    target: Optional[torch.Tensor],    # [B, Q, D] | None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [dec_layers, B, Q, D], memory [B, L, D])."""
    memory = src
    for layer in detr.encoder.layers:
        memory = fused_encoder_layer(memory, mask, pos, layer)
    return detr.decode(memory, mask, pos, query_embed, target), memory
