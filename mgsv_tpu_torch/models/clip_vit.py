"""CLIP ViT-B/32 visual tower (the frozen frame encoder), ported from
mgsv_tpu/models/clip_vit.py.

The OpenAI CLIP image encoder (`encode_image`): 32 x 32 conv patches
without bias over 224 x 224 -> 7 x 7 tokens, a class token, a learned
positional embedding, ln_pre, 12 pre-norm blocks with QuickGELU MLPs,
ln_post on the class token, then the projection to 512.

The tower's parameters carry CLIP's `visual.*` names, except inside the
blocks, which carry the shared ViTBlock's (timm's) names;
`import_clip_visual_state_dict` renames a CLIP state dict's block keys
(packed `attn.in_proj_weight` -> `attn.qkv.weight`, ...), so it loads
with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.models.vit_common import ViTBlock, default_attention, layer_norm

# CLIP preprocessing constants (dataloader_MGSV_EC_rawdata.py:18-25)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# CLIP resblock names -> ViTBlock names
_BLOCK_RENAMES = (("ln_1.", "norm1."), ("attn.in_proj_weight", "attn.qkv.weight"),
                  ("attn.in_proj_bias", "attn.qkv.bias"), ("attn.out_proj.", "attn.proj."),
                  ("ln_2.", "norm2."), ("mlp.c_fc.", "mlp.fc1."), ("mlp.c_proj.", "mlp.fc2."))


class _Transformer(nn.Module):
    def __init__(self, width: int, depth: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ViTBlock(width, heads, act="quick_gelu", dtype=dtype) for _ in range(depth))


class ClipVisionTower(nn.Module):
    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12, patch: int = 32,
                 out_dim: int = 512, image_size: int = 224,
                 attention_fn: Callable = default_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch, self.dtype, self.attention_fn = patch, dtype, attention_fn
        grid = (image_size // patch) ** 2
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, depth, heads, dtype)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, out_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, 3, H, W] (CLIP-normalized) -> [B, out_dim]."""
        b = images.shape[0]
        x = F.conv2d(images.to(self.dtype), self.conv1.weight.to(self.dtype),
                     stride=self.patch)                               # [B, W, g, g]
        x = x.flatten(2).transpose(1, 2).float()                      # [B, g*g, W], row-major grid
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = layer_norm(x, self.ln_pre)
        for block in self.transformer.resblocks:
            x = block(x, self.attention_fn)
        return layer_norm(x[:, 0], self.ln_post) @ self.proj


def import_clip_visual_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CLIP state dict (`visual.*` keys, or a visual-only one) -> the
    tower's state dict."""
    s = {k[len("visual."):]: v for k, v in state.items() if k.startswith("visual.")}
    if not s:
        s = dict(state)
    out = {}
    for key, value in s.items():
        if key.startswith("transformer.resblocks."):
            for old, new in _BLOCK_RENAMES:
                key = key.replace(old, new)
        out[key] = torch.as_tensor(value, dtype=torch.float32)
    return out
