"""The process group of a data-parallel run; the twin of
mgsv_tpu/core/dist.py over torch.distributed.

One process a rank.  `initialize` joins the group: with a coordinator
address ("host:port") it calls `init_process_group("tcp://host:port")`;
without one it reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK), the counterpart of `jax.distributed.initialize()`'s
auto-discovery; with neither it does nothing and the run has one process.
The backend follows the device, and is chosen before the group exists,
never after an error: NCCL when each rank on the host has a card of its
own, gloo on the CPU and when ranks share one card (NCCL refuses two ranks
on one device).  `rank_device` maps a rank to its card, `is_primary`
gates the one writer, `to_host` gathers per-row results into identical
host copies on every rank, and `barrier` is a named sync point.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("mgsv_tpu_torch")


def _local_world(num_processes: int) -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else every process
    of the run (a --coordinator launch starts its processes on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def _local_rank(process_id: int, num_processes: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id % _local_world(num_processes)))


def backend_for(device: str | torch.device, num_processes: int) -> str:
    """"nccl" where every rank on this host has a CUDA device of its own,
    "gloo" on the CPU and where ranks share a card."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= _local_world(num_processes):
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device) -> torch.device:
    """This rank's device for a run asked to train on `device` ("cuda" or
    "cpu"): cuda:local_rank where each rank has a card, cuda:0 for every
    rank where they share one; the device itself outside a group."""
    device = torch.device(device)
    if device.type != "cuda" or not dist.is_initialized() or device.index is not None:
        return device
    local = _local_rank(dist.get_rank(), dist.get_world_size())
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str | torch.device = "cuda") -> bool:
    """Join the run's process group; True when there is one.  coordinator
    "host:port" with num_processes and process_id, or torchrun's
    environment; neither: a no-op (one process).  device: the device the
    run trains on, which picks the backend (`backend_for`)."""
    if dist.is_initialized():
        return True
    if coordinator is None:
        env = os.environ
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
            return False
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    backend = backend_for(device, num_processes)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(_local_rank(process_id, num_processes)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    logger.info("torch.distributed initialized: rank %d of %d over %s", process_id,
                num_processes, backend)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def to_host(x: torch.Tensor, group=None) -> np.ndarray:
    """This rank's rows of a per-row result -> the whole result as a host
    numpy copy, identical on every rank of `group` (None: every rank): the
    ranks' rows in group order (an all-gather over the group); outside a
    group, the rows themselves.  Over a (dp, mp) mesh pass its dp group:
    the mp replicas of a dp index hold the same rows."""
    if process_count() > 1:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts)
    return x.detach().cpu().numpy()


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for every other (the reference's
    torch.distributed.barrier, train-MaDe.py:634); a no-op outside a
    group."""
    if process_count() > 1:
        logger.debug("barrier %s", name)
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
