"""Input pipeline: background batch assembly and asynchronous copies to the
device; the single-process part of mgsv_tpu/data/pipeline.py.

A background thread gathers the next batches from the stores (the native
gather of runtime/native.py widens float16 to float32 in its copy, on its
own threads, with the interpreter lock released) into page-locked host
memory when the device is a GPU, while the current step runs; the consumer copies each batch to the
device with `non_blocking=True`, so the copy overlaps the work already
queued there.  A producer error is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.data.dataset import BatchMeta, MgsvDataset, epoch_index_batches

HostBatch = Dict[str, torch.Tensor]


def _host_batch(dataset: MgsvDataset, idx: np.ndarray, valid: np.ndarray,
                pin: bool) -> Tuple[HostBatch, BatchMeta]:
    batch, meta = dataset.gather(idx)
    meta.valid &= valid
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if pin:
        tensors = {k: t.pin_memory() for k, t in tensors.items()}
    return tensors, meta


def _to_device(batch: HostBatch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: t.to(device, non_blocking=True) for k, t in batch.items()}


def prefetch_epoch(
    dataset: MgsvDataset,
    batch_size: int,
    *,
    shuffle: bool,
    device,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    depth: int = 2,
    start_batch: int = 0,
) -> Iterator[Tuple[Dict[str, torch.Tensor], BatchMeta]]:
    """Iterate (batch on `device`, meta) over one epoch of
    `epoch_index_batches`, with up to `depth` batches gathered ahead."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def producer():
        try:
            for idx, valid in epoch_index_batches(
                    len(dataset), batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                    drop_last=drop_last, start_batch=start_batch):
                if stop.is_set():
                    return
                q.put(_host_batch(dataset, idx, valid, pin))
        except BaseException as e:  # re-raised in the consumer
            q.put(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            batch, meta = item
            yield _to_device(batch, device), meta
    finally:
        stop.set()
        # drain so a producer blocked on a full queue can see `stop` and exit
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join(timeout=5)
