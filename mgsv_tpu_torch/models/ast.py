"""AST, the Audio Spectrogram Transformer (the frozen audio tower), ported
from mgsv_tpu/models/ast.py.

timm's DeiT base384-distilled as the AST wraps it: a 1-channel 16 x 16 conv
patch embedding with overlapping strides (10 x 10), cls and distillation
tokens, a [1, patches + 2, 768] positional embedding, 12 pre-norm ViT
blocks, a final LayerNorm and an MLP head.  MaDe consumes (cls + dist) / 2.
Input: spectrograms [B, time, mel], convolved as [B, 1, mel, time]; the
patches are flattened frequency-major, as the JAX package's reshape of its
[B, f, t, D] conv output does, so each gets the positional embedding the
checkpoint trained it with.

The parameters carry the reference checkpoint's names (`v.patch_embed.proj`,
`v.cls_token`, `v.blocks.{i}`, `v.norm`, `mlp_head.{0,1}`), so an AST
state dict loads with `load_state_dict(strict=True)` after
`import_ast_state_dict` (DDP prefixes stripped, optional RGB-patch sum and
ImageNet pos-embed surgery, done in numpy as the JAX package does).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.models.vit_common import ViTBlock, default_attention, layer_norm

# timm's ImageNet classifier heads of the wrapped DeiT: AST checkpoints carry
# them, AST's forward never reads them (it classifies through mlp_head)
UNUSED_AST_KEYS = ("v.head.", "v.head_dist.")


def patch_grid(fstride: int, tstride: int, input_fdim: int = 128,
               input_tdim: int = 1024, kernel: int = 16):
    """The conv's output grid (f_dim, t_dim): the strided-conv size formula."""
    f_dim = (input_fdim - kernel) // fstride + 1
    t_dim = (input_tdim - kernel) // tstride + 1
    return f_dim, t_dim


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, fstride: int, tstride: int):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, 16, stride=(fstride, tstride))


class _DeiT(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, num_patches: int, fstride: int,
                 tstride: int, dtype: torch.dtype):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim, fstride, tstride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 2, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads, dtype=dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class ASTEncoder(nn.Module):
    def __init__(self, embed_dim: int = 768, depth: int = 12, heads: int = 12,
                 label_dim: int = 527, fstride: int = 10, tstride: int = 10,
                 input_fdim: int = 128, input_tdim: int = 1024,
                 attention_fn: Callable = default_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fstride, self.tstride = fstride, tstride
        self.dtype, self.attention_fn = dtype, attention_fn
        f_dim, t_dim = patch_grid(fstride, tstride, input_fdim, input_tdim)
        self.v = _DeiT(embed_dim, depth, heads, f_dim * t_dim, fstride, tstride, dtype)
        self.mlp_head = nn.Sequential(nn.LayerNorm(embed_dim, eps=1e-5),
                                      nn.Linear(embed_dim, label_dim))

    def forward(self, spec: torch.Tensor):
        """spec: [B, T, F] -> (logits [B, label_dim], cls_dist [B, D],
        tokens [B, L, D])."""
        b = spec.shape[0]
        conv = self.v.patch_embed.proj
        x = spec.transpose(1, 2).unsqueeze(1)                        # [B, 1, F, T]
        x = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                     stride=(self.fstride, self.tstride))          # [B, D, f, t]
        x = x.flatten(2).transpose(1, 2).float()                     # [B, f*t, D], f-major
        x = torch.cat([self.v.cls_token.expand(b, -1, -1),
                       self.v.dist_token.expand(b, -1, -1), x], dim=1) + self.v.pos_embed
        for block in self.v.blocks:
            x = block(x, self.attention_fn)
        x = layer_norm(x, self.v.norm)
        cls_dist = (x[:, 0] + x[:, 1]) / 2.0
        logits = self.mlp_head[1](layer_norm(cls_dist, self.mlp_head[0]))
        return logits, cls_dist, x


# ---------------------------------------------------------------------------
# Weight conversion (numpy, as mgsv_tpu/models/ast.py does it)
# ---------------------------------------------------------------------------

def _strip_prefixes(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop DataParallel/DDP 'module.' prefixes (the reference wraps the AST
    in DDP before saving, so checkpoint keys carry them)."""
    out = {}
    for k, v in state.items():
        while k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def surgery_pos_embed(imagenet_pos: np.ndarray, f_dim: int, t_dim: int,
                      original_hw: int = 24) -> np.ndarray:
    """The reference's ImageNet pos-embed adaptation (ast_models.py:89-106).

    imagenet_pos: [1, original_hw^2 + 2, D] -> [1, f_dim * t_dim + 2, D]:
    grid part reshaped to [D, hw, hw], center-cut (or bilinearly resized)
    along time then frequency, re-flattened; cls/dist rows kept.
    """
    d = imagenet_pos.shape[2]
    lead = imagenet_pos[:, :2]
    grid = imagenet_pos[:, 2:].reshape(1, original_hw * original_hw, d)
    grid = grid.transpose(0, 2, 1).reshape(1, d, original_hw, original_hw)

    def cut_or_resize(arr, target, axis):
        size = arr.shape[axis]
        if target <= size:
            start = size // 2 - target // 2
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(start, start + target)
            return arr[tuple(sl)]
        return _bilinear_resize(arr, target, axis)

    grid = cut_or_resize(grid, t_dim, axis=3)
    grid = cut_or_resize(grid, f_dim, axis=2)
    grid = grid.reshape(1, d, f_dim * t_dim).transpose(0, 2, 1)
    return np.concatenate([lead, grid], axis=1)


def _bilinear_resize(arr: np.ndarray, target: int, axis: int) -> np.ndarray:
    """align_corners=False bilinear resize along one axis (matches
    F.interpolate(mode='bilinear') as used at ast_models.py:97,102)."""
    size = arr.shape[axis]
    scale = size / target
    coords = (np.arange(target) + 0.5) * scale - 0.5
    lo = np.clip(np.floor(coords).astype(int), 0, size - 1)
    hi = np.clip(lo + 1, 0, size - 1)
    w = np.clip(coords - lo, 0.0, 1.0)
    a = np.take(arr, lo, axis=axis)
    b_ = np.take(arr, hi, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = target
    w = w.reshape(shape)
    return a * (1 - w) + b_ * w


def import_ast_state_dict(state: Mapping[str, np.ndarray],
                          sum_rgb_patch: bool = False) -> Dict[str, torch.Tensor]:
    """timm-AST state dict (numpy values) -> the encoder's state dict.

    Takes the audioset checkpoint layout (pos_embed already sized for the
    12 x 101 audio grid) and a raw ImageNet DeiT (with `sum_rgb_patch=True`
    its 3-channel patch conv is summed to 1 channel and its square pos_embed
    goes through `surgery_pos_embed`).  `UNUSED_AST_KEYS` are dropped.
    """
    state = {k: v for k, v in _strip_prefixes(state).items()
             if not k.startswith(UNUSED_AST_KEYS)}
    conv_w = np.asarray(state["v.patch_embed.proj.weight"])     # [768, C, 16, 16]
    if sum_rgb_patch and conv_w.shape[1] == 3:
        conv_w = conv_w.sum(axis=1, keepdims=True)
    state["v.patch_embed.proj.weight"] = conv_w

    pos = np.asarray(state["v.pos_embed"])
    if sum_rgb_patch:
        f_dim, t_dim = patch_grid(10, 10)
        if pos.shape[1] != f_dim * t_dim + 2:
            hw = int(round(math.sqrt(pos.shape[1] - 2)))
            if hw * hw != pos.shape[1] - 2:
                raise ValueError(
                    f"pos_embed length {pos.shape[1]} is neither the audio "
                    f"grid ({f_dim * t_dim + 2}) nor a square ImageNet grid")
            pos = surgery_pos_embed(pos, f_dim, t_dim, original_hw=hw)
    state["v.pos_embed"] = pos
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in state.items()}
