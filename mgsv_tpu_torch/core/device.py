"""Device selection for the port.

Every entry point takes an explicit device; this resolves its name and pins
float32 matmuls and convolutions to full float32 (TF32 off), so numbers
compared against the JAX reference or against a kernel's plain version are
not rounded to TF32's ten mantissa bits.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """Device for `name` ("cuda", "cuda:1", "cpu"), with TF32 off.

    Raises when a CUDA device is asked for and none is present: a run that
    was meant for the card must not silently land on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
