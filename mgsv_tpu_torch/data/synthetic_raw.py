"""Seeded raw media and frozen-tower checkpoints for driving feature
extraction without MGSV-EC's media or the pretrained towers.

The raw-media counterpart of data/synthetic.py: per-second JPEG frame
directories, WAV tracks, an MGSV-EC-schema CSV, and tower checkpoints with
random weights in the reference's on-disk layouts (CLIP's `visual.*` state
dict as in ViT-B-32.pt; the audioset AST blob, `model_state_dict` with DDP
`module.` prefixes), so `cli/extract_features.py` infers their geometry
exactly as it does for the real files.  Everything is drawn from the
numpy Generator the caller passes.
"""

from __future__ import annotations

import csv
import os
import wave
from typing import Sequence

import numpy as np
import torch

CSV_FIELDS = ("video_id", "music_id", "video_start", "video_end", "music_start", "music_end",
              "music_total_duration", "video_segment_duration", "music_segment_duration",
              "music_path", "video_total_duration", "video_width", "video_height",
              "video_total_frames", "video_frame_rate", "video_category")


def _normal(rng: np.random.Generator, shape, scale: float) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape, dtype=np.float32) * scale))


def _vit_block(rng, s: dict, prefix: str, names: Sequence[str], d: int) -> None:
    """One pre-norm block's tensors under `prefix`, with `names` the
    checkpoint's (norm1, qkv, proj, norm2, fc1, fc2) names."""
    n1, qkv, proj, n2, fc1, fc2 = names
    w = 1.0 / np.sqrt(d)
    s.update({f"{prefix}.{n1}.weight": torch.ones(d), f"{prefix}.{n1}.bias": torch.zeros(d),
              f"{prefix}.{qkv}weight": _normal(rng, (3 * d, d), w),
              f"{prefix}.{qkv}bias": _normal(rng, (3 * d,), 0.02),
              f"{prefix}.{proj}.weight": _normal(rng, (d, d), w),
              f"{prefix}.{proj}.bias": _normal(rng, (d,), 0.02),
              f"{prefix}.{n2}.weight": torch.ones(d), f"{prefix}.{n2}.bias": torch.zeros(d),
              f"{prefix}.{fc1}.weight": _normal(rng, (4 * d, d), w),
              f"{prefix}.{fc1}.bias": _normal(rng, (4 * d,), 0.02),
              f"{prefix}.{fc2}.weight": _normal(rng, (d, 4 * d), 0.5 * w),
              f"{prefix}.{fc2}.bias": _normal(rng, (d,), 0.02)})


def mint_clip_checkpoint(path: str, rng: np.random.Generator, width: int = 768,
                         depth: int = 12, patch: int = 32, grid: int = 7,
                         out_dim: int = 512) -> None:
    """A CLIP visual tower checkpoint (`visual.*` keys, packed in_proj);
    the defaults are ViT-B/32's geometry."""
    s = {"conv1.weight": _normal(rng, (width, 3, patch, patch), 1.0 / patch / np.sqrt(3)),
         "class_embedding": _normal(rng, (width,), 0.02),
         "positional_embedding": _normal(rng, (grid * grid + 1, width), 0.01),
         "ln_pre.weight": torch.ones(width), "ln_pre.bias": torch.zeros(width),
         "ln_post.weight": torch.ones(width), "ln_post.bias": torch.zeros(width),
         "proj": _normal(rng, (width, out_dim), 1.0 / np.sqrt(width))}
    for i in range(depth):
        _vit_block(rng, s, f"transformer.resblocks.{i}",
                   ("ln_1", "attn.in_proj_", "attn.out_proj", "ln_2", "mlp.c_fc", "mlp.c_proj"),
                   width)
    torch.save({f"visual.{k}": v for k, v in s.items()}, path)


def mint_ast_checkpoint(path: str, rng: np.random.Generator, dim: int = 768, depth: int = 12,
                        label_dim: int = 527, f_dim: int = 12, t_dim: int = 101) -> None:
    """An AST checkpoint in the audioset file's layout, pos_embed sized for
    an f_dim x t_dim patch grid; the defaults are the audioset AST's
    geometry (768 wide, 12 blocks, 12 x 101 patches: 1,214 tokens)."""
    s = {"v.patch_embed.proj.weight": _normal(rng, (dim, 1, 16, 16), 1.0 / 16),
         "v.patch_embed.proj.bias": _normal(rng, (dim,), 0.02),
         "v.cls_token": _normal(rng, (1, 1, dim), 0.02),
         "v.dist_token": _normal(rng, (1, 1, dim), 0.02),
         "v.pos_embed": _normal(rng, (1, f_dim * t_dim + 2, dim), 0.02),
         "v.norm.weight": torch.ones(dim), "v.norm.bias": torch.zeros(dim),
         "mlp_head.0.weight": torch.ones(dim), "mlp_head.0.bias": torch.zeros(dim),
         "mlp_head.1.weight": _normal(rng, (label_dim, dim), 1.0 / np.sqrt(dim)),
         "mlp_head.1.bias": torch.zeros(label_dim)}
    for i in range(depth):
        _vit_block(rng, s, f"v.blocks.{i}",
                   ("norm1", "attn.qkv.", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"), dim)
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in s.items()}}, path)


def write_frames(frame_dir: str, rng: np.random.Generator, seconds: int,
                 size=(320, 240)) -> None:
    """`seconds` 1 fps JPEG frames {0..seconds-1}.jpg of random 8 x 8
    colour blocks, (width, height) = size, both multiples of 8."""
    from PIL import Image

    os.makedirs(frame_dir, exist_ok=True)
    for sec in range(seconds):
        blocks = rng.integers(0, 256, (size[1] // 8, size[0] // 8, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(blocks, 8, axis=0), 8, axis=1)
        Image.fromarray(img).save(os.path.join(frame_dir, f"{sec}.jpg"), quality=90)


def write_wav(path: str, rng: np.random.Generator, seconds: float, sample_rate: int) -> None:
    """A mono 16-bit WAV of `seconds` of noise under a few tones."""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    freqs = rng.uniform(100.0, 4000.0, 4)
    x = sum(np.sin(2 * np.pi * f * t) for f in freqs) / 8
    x = x + 0.05 * rng.standard_normal(t.shape)
    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def write_csv(path: str, rows: Sequence[dict]) -> None:
    """An MGSV-EC-schema CSV; each row gives video_id, music_id,
    video_start, video_end, music_start, music_end, music_total_duration
    (the other columns get placeholders)."""
    with open(path, "w", newline="") as f:
        out = csv.DictWriter(f, CSV_FIELDS)
        out.writeheader()
        for r in rows:
            full = {"video_segment_duration": r["video_end"] - r["video_start"],
                    "music_segment_duration": r["music_end"] - r["music_start"],
                    "music_path": "-", "video_total_duration": r["video_end"],
                    "video_width": 320, "video_height": 240, "video_total_frames": 0,
                    "video_frame_rate": 30, "video_category": "-"}
            full.update(r)
            out.writerow(full)
