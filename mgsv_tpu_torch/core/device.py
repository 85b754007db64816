"""Device selection for the port.

Every entry point takes an explicit device; this resolves its name and pins
float32 matmuls and convolutions to full float32 (TF32 off), so numbers
compared against the JAX reference or against a kernel's plain version are
not rounded to TF32's ten mantissa bits.
"""

from __future__ import annotations

from typing import Sequence

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


def write_to_device(buffer: torch.Tensor, values: Sequence[float]) -> None:
    """buffer[:len(values)] = values, in buffer's dtype, without the host
    waiting for the device: on CUDA through a pinned staging tensor and one
    non-blocking copy.  PyTorch's pinned-memory allocator keeps the staging
    block from reuse until that copy has run, so a host running steps ahead
    of the device never overwrites values a queued copy has yet to read."""
    host = torch.tensor(values, dtype=buffer.dtype, pin_memory=buffer.is_cuda)
    buffer[:len(values)].copy_(host, non_blocking=True)


def check_mesh_shape(mesh_shape, world: int = 1) -> tuple:
    """Check a `train.mesh_shape` (dp, mp) against a run of `world`
    processes, one rank each (core/mesh.py), and return it resolved, with
    dp * mp = world.  dp -1 means world / mp and mp -1 world / dp, as JAX's
    make_mesh reads them (mgsv_tpu/core/mesh.py:23-43); (1, 1) means every
    rank on dp, as JAX's Trainer reads it.  A shape of more than one rank
    in a single process raises NotImplementedError: JAX runs such a mesh
    over several devices of one process, the port one process a rank.  An
    axis that does not divide the world, or a shape that is not the
    world's, raises ValueError."""
    dp, mp = (int(v) for v in mesh_shape)
    if (dp, mp) == (1, 1):
        return world, 1
    if world == 1 and max(dp, mp) > 1:
        raise NotImplementedError(
            f"train.mesh_shape={tuple(mesh_shape)} in one process: the port runs one "
            "process a rank; launch dp * mp processes (cli.train --coordinator, or "
            "torchrun) (ROADMAP.md, queue 1: multi-GPU, one process over several devices)")
    if -1 in (dp, mp) and dp != mp:
        known = mp if dp == -1 else dp
        if known < 1 or world % known:
            raise ValueError(f"train.mesh_shape={tuple(mesh_shape)}: {known} does not "
                             f"divide a run of {world} ranks")
        dp, mp = (world // known, known) if dp == -1 else (known, world // known)
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"train.mesh_shape={tuple(mesh_shape)} in a run of {world} ranks: "
                         f"dp x mp must be {world} (dp -1: {world} / mp)")
    return dp, mp
