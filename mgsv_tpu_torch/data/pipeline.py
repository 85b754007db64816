"""Input pipeline: background batch assembly and asynchronous copies to the
device; ported from mgsv_tpu/data/pipeline.py.

A background thread gathers the next batches from the stores (the native
gather of runtime/native.py widens float16 to float32 in its copy, on its
own threads, with the interpreter lock released) into page-locked host
memory when the device is a GPU, while the current step runs; the consumer copies each batch to the
device with `non_blocking=True`, so the copy overlaps the work already
queued there.  A producer error is raised in the consumer.

Over a (dp, mp) mesh (core/mesh.py) every rank draws the same seeded
index stream and gathers only its dp index's rows of each global batch
(`process_local_rows`; the mp replicas gather the same), the per-rank
feeding of JAX's make_array_from_process_local_data
(mgsv_tpu/data/pipeline.py:24-75).  The music codes are computed over the global batch and then sliced, since
under loss.ignore_same_music 0 the negatives they mask span every rank;
the batch's meta stays global.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.core.mesh import Mesh, process_local_rows
from mgsv_tpu_torch.data.dataset import BatchMeta, MgsvDataset, epoch_index_batches

HostBatch = Dict[str, torch.Tensor]


def _host_batch(dataset: MgsvDataset, idx: np.ndarray, valid: np.ndarray,
                pin: bool, mesh: Optional[Mesh] = None) -> Tuple[HostBatch, BatchMeta]:
    if mesh is None:
        batch, meta = dataset.gather(idx)
        meta.valid &= valid
    else:
        local = process_local_rows(len(idx), mesh)
        batch, _ = dataset.gather(idx[local])
        codes = np.unique(dataset.music_rows[idx], return_inverse=True)[1].astype(np.int32)
        batch["music_codes"] = codes[local]
        ix = dataset.index
        meta = BatchMeta(video_ids=[ix.video_ids[i] for i in idx],
                         music_ids=[ix.music_ids[i] for i in idx], valid=valid.copy())
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
    mesh: Optional[Mesh] = None,
) -> Iterator[Tuple[Dict[str, torch.Tensor], BatchMeta]]:
    """Iterate (batch on `device`, meta) over one epoch of
    `epoch_index_batches`, with up to `depth` batches gathered ahead.
    mesh: each batch is this rank's rows of the global batch of
    `batch_size`, its meta the global batch's."""
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
                q.put(_host_batch(dataset, idx, valid, pin, mesh))
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
