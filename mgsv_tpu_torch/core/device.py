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


def check_mesh_shape(mesh_shape, world: int = 1) -> None:
    """Check a `train.mesh_shape` (dp, mp) against a run of `world`
    processes, one rank each (core/mesh.py).  dp -1 and (1, 1) mean every
    rank, as JAX's Trainer reads (1, 1) as every device; dp may also be the
    world itself.  mp > 1 raises NotImplementedError: only JAX's 2-D
    evaluation similarity uses the model axis, and it is not ported.  A dp
    above 1 in a single process raises NotImplementedError too: JAX runs
    such a mesh over several devices of one process, the port one process a
    rank.  Any other dp raises ValueError."""
    dp, mp = (int(v) for v in mesh_shape)
    if mp not in (1, -1) or (mp == -1 and world > 1 and dp != world):
        raise NotImplementedError(
            f"train.mesh_shape={tuple(mesh_shape)}: a model axis above 1 serves JAX's 2-D "
            "evaluation similarity, which is not ported yet (ROADMAP.md, queue 1: the 2-D "
            "similarity)")
    if dp in (-1, world) or (dp, mp) == (1, 1):
        return
    if world == 1:
        raise NotImplementedError(
            f"train.mesh_shape={tuple(mesh_shape)} in one process: the port runs one "
            "process a rank; launch dp processes (cli.train --coordinator, or torchrun) "
            "(ROADMAP.md, queue 1: multi-GPU, one process over several devices)")
    raise ValueError(f"train.mesh_shape={tuple(mesh_shape)} in a run of {world} ranks: dp "
                     f"must be -1 or {world}")
