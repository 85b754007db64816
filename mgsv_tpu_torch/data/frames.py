"""Video frame frontend: CLIP preprocessing + per-second frame selection,
the port's copy of mgsv_tpu/data/frames.py.

Re-derivation of the raw-frame path (dataloader_MGSV_EC_rawdata.py:18-25,
41-92): bicubic resize so the short side is 224, center-crop 224x224,
RGB [0,1], normalize with CLIP mean/std; frames are 1 fps JPEGs indexed
`{second}.jpg` (with an `end.jpg` fallback for the final frame), padded to
max_v_frames with black frames and a validity mask.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

from mgsv_tpu_torch.models.clip_vit import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def preprocess_image(img: "PIL.Image.Image", resolution: int = 224) -> np.ndarray:
    """PIL image -> CLIP-normalized [3, res, res] float32 (NCHW like torch)."""
    from PIL import Image

    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left = (w - resolution) // 2
    top = (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    img = img.convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0                  # [H, W, 3]
    mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.asarray(CLIP_IMAGE_STD, np.float32)
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1)


def black_frame(resolution: int = 224) -> np.ndarray:
    """The padding frame: a black image through the same normalization
    (the reference pads with transformed black images, rawdata.py:86-89)."""
    mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.asarray(CLIP_IMAGE_STD, np.float32)
    pix = (0.0 - mean) / std
    return np.broadcast_to(
        pix[:, None, None], (3, resolution, resolution)).astype(np.float32)


def load_clip_frames(
    frame_dir: str,
    video_start: float,
    video_end: float,
    max_v_frames: int = 50,
    resolution: int = 224,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-second JPEG frames -> ([max_v_frames, 3, res, res], mask).

    Frame selection rules from get_clip_frame (rawdata.py:41-92): floor the
    start/end seconds, clamp the end to both the available frame count and
    max_v_frames, fall back to `end.jpg` for a missing final frame.
    """
    from PIL import Image

    n_avail = len(os.listdir(frame_dir))
    start = math.floor(video_start)
    end = min(math.floor(video_end), n_avail - 1, max_v_frames - 1)
    # The ABSOLUTE clamp to max_v_frames-1 reproduces the reference
    # bit-for-bit (rawdata.py:67, valid under its documented in-domain
    # assumption "all video_start_time < 0.5" so start is always 0; for
    # start > 0 the reference silently truncates the tail and we match,
    # so cached features stay identical).  But a window starting past the
    # clamp would yield ZERO frames — an all-masked sample that poisons
    # attention downstream; the reference's assert does not catch it
    # (end-start+1 goes negative).  Fail loudly instead.
    if end < start:
        raise ValueError(
            f"empty frame window for {frame_dir}: start={start}s after "
            f"clamped end={end}s (n_avail={n_avail}, "
            f"max_v_frames={max_v_frames}) — MGSV-EC guarantees "
            "video_start < 0.5 s; for other data keep windows inside the "
            "first max_v_frames seconds")

    frames = np.empty((max_v_frames, 3, resolution, resolution), np.float32)
    mask = np.zeros(max_v_frames, np.float32)
    slot = 0
    for sec in range(start, end + 1):
        name = f"{sec}.jpg"
        path = os.path.join(frame_dir, name)
        if (sec == n_avail - 1 and not os.path.exists(path)
                and os.path.exists(os.path.join(frame_dir, "end.jpg"))):
            path = os.path.join(frame_dir, "end.jpg")
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing frame: {path}")
        frames[slot] = preprocess_image(Image.open(path), resolution)
        mask[slot] = 1.0
        slot += 1
    if slot < max_v_frames:
        frames[slot:] = black_frame(resolution)[None]
    return frames, mask
