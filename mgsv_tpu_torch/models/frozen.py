"""Frozen-encoder batch runners: raw media -> reference-compatible features,
ported from mgsv_tpu/models/frozen.py.

CLIP ViT-B/32 encodes 1 fps frames to [F, 512]; the AST encodes snippet
spectrograms to [S, 768] (the snippet axis is the AST batch).  Both run
under `torch.inference_mode()` on an explicit device, with their attention
routed through `ops/cuda/flash_attention.py::make_attention_fn()`: the
AST's 1,214 keys take the flash-attention kernel on a CUDA device (its
plain version on the CPU), CLIP's 50 keys the plain einsum path.
"""

from __future__ import annotations

import torch

from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.models.ast import ASTEncoder
from mgsv_tpu_torch.models.clip_vit import ClipVisionTower
from mgsv_tpu_torch.ops.cuda.flash_attention import make_attention_fn


class FrozenEncoders:
    def __init__(self, clip_tower: ClipVisionTower, ast_encoder: ASTEncoder,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        attention = make_attention_fn()
        for tower in (clip_tower, ast_encoder):
            tower.attention_fn = attention
            tower.to(self.device).eval().requires_grad_(False)
        self.clip_tower, self.ast_encoder = clip_tower, ast_encoder

    @torch.inference_mode()
    def encode_frames(self, frames) -> torch.Tensor:
        """[B, F, 3, H, W] CLIP-normalized -> [B, F, 512] on the device."""
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        b, f = frames.shape[:2]
        return self.clip_tower(frames.reshape(b * f, *frames.shape[2:])).reshape(b, f, -1)

    @torch.inference_mode()
    def encode_snippets(self, specs) -> torch.Tensor:
        """[B, S, T, mel] normalized spectrograms -> [B, S, 768] (the AST's
        cls_dist feature) on the device."""
        specs = torch.as_tensor(specs, dtype=torch.float32, device=self.device)
        b, s = specs.shape[:2]
        _, cls_dist, _ = self.ast_encoder(specs.reshape(b * s, *specs.shape[2:]))
        return cls_dist.reshape(b, s, -1)
