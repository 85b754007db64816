"""Whole-dataset device residency with the batch gather on the device;
ported from mgsv_tpu/data/device_data.py (one device).

The packed stores go to the device once, in their storage dtypes (float16
features, uint8 masks), with the row maps and per-row metadata; every batch
is then assembled there by `gather_batch`, op for op JAX's: index, cast to
float32, multiply by the mask.  Values equal the host pipeline's bit for
bit (the float16 -> float32 widening and a product with 0 or 1 are exact).

`DeviceResidentData` has the dataset's iterator surface (`index`,
`__len__`, `num_batches`, `epoch_batches` with `start_batch`) and the same
seeded permutation, so the Trainer and the evaluator take either.  An
epoch's indices and music codes are computed on the host and copied to the
device once per epoch, not once per batch.

`use_device_data` is the residency policy of the Trainer and the
evaluation CLI (mgsv_tpu/train/loop.py, mgsv_tpu/cli/evaluate.py): "on"
always, "off" never, "auto" on a CUDA device when the stores take less
than RESIDENT_BUDGET bytes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.data.dataset import BatchMeta, MgsvDataset, epoch_index_batches

Batch = Dict[str, torch.Tensor]

# JAX's "auto" budget for one device's share of the stores
RESIDENT_BUDGET = 6 << 30


def dataset_device_bytes(dataset: MgsvDataset) -> int:
    """Bytes the stores take on the device, in their storage dtypes."""
    total = 0
    for store in (dataset.video_store, dataset.music_store):
        for arr in store.arrays.values():
            total += int(np.prod(arr.shape)) * np.dtype(arr.dtype).itemsize
    return total


def use_device_data(mode: str, device, dataset: MgsvDataset) -> bool:
    """Whether `dataset` should be made resident on `device` under
    train.device_data = mode ("on" | "off" | "auto")."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"train.device_data={mode!r}: expected 'auto', 'on' or 'off'")
    return (torch.device(device).type == "cuda"
            and dataset_device_bytes(dataset) < RESIDENT_BUDGET)


def gather_batch(tree: Dict[str, torch.Tensor], idx: torch.Tensor) -> Batch:
    """The batch of dataset rows `idx` (a tensor on the tables' device),
    assembled from the resident tables (`DeviceResidentData.tree`), without
    the music codes."""
    vr = tree["video_rows"][idx]
    mr = tree["music_rows"][idx]
    fm = tree["vm"][vr].to(torch.float32)
    sm = tree["mm"][mr].to(torch.float32)
    ff = tree["vf"][vr].to(torch.float32) * fm[..., None]
    sf = tree["mf"][mr].to(torch.float32) * sm[..., None]
    return {
        "frame_feats": ff, "frame_mask": fm,
        "segment_feats": sf, "segment_mask": sm,
        "spans_target": tree["spans"][idx],
        "gt_moment": tree["gt"][idx],
        "m_duration": tree["mdur"][idx],
        "v_duration": tree["vdur"][idx],
    }


class DeviceResidentData:
    def __init__(self, dataset: MgsvDataset, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError("dp-sharded device residency is not ported yet "
                                      "(ROADMAP.md, queue 1: multi-GPU)")
        self.index = dataset.index
        self._music_rows = np.asarray(dataset.music_rows)
        vs, ms, ix = dataset.video_store, dataset.music_store, dataset.index
        all_v, all_m = np.arange(len(vs)), np.arange(len(ms))
        host = {
            "vf": vs.gather("feats", all_v, dtype=None),
            "vm": vs.gather("mask", all_v, dtype=None),
            "mf": ms.gather("feats", all_m, dtype=None),
            "mm": ms.gather("mask", all_m, dtype=None),
            "video_rows": np.asarray(dataset.video_rows, np.int64),
            "music_rows": self._music_rows.astype(np.int64),
            # the host batch's arrays, dtypes unchanged
            "spans": ix.spans_target, "gt": ix.gt_moment,
            "mdur": ix.m_duration, "vdur": ix.v_duration,
        }
        self.tree = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in host.items()}
        self.device = self.tree["vf"].device          # with its index: cuda:0, not cuda

    def __len__(self) -> int:
        return len(self.index)

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)

    def epoch_batches(
        self, batch_size: int, *, shuffle: bool, seed: int = 0, epoch: int = 0,
        drop_last: bool = True, start_batch: int = 0,
    ) -> Iterator[Tuple[Batch, BatchMeta]]:
        """As MgsvDataset.epoch_batches, the batches on the device."""
        stream = list(epoch_index_batches(len(self), batch_size, shuffle=shuffle, seed=seed,
                                          epoch=epoch, drop_last=drop_last,
                                          start_batch=start_batch))
        if not stream:
            return
        idx_all = np.stack([idx for idx, _ in stream])
        # per-batch integer codes of the music track (the ignore_same_music
        # InfoNCE branch), as the host batch's
        codes = np.stack([np.unique(self._music_rows[idx], return_inverse=True)[1]
                          for idx in idx_all]).astype(np.int32)
        idx_dev = torch.from_numpy(idx_all).to(self.device)
        codes_dev = torch.from_numpy(codes).to(self.device)
        ix = self.index
        for i, (idx, valid) in enumerate(stream):
            batch = gather_batch(self.tree, idx_dev[i])
            batch["music_codes"] = codes_dev[i]
            meta = BatchMeta(video_ids=[ix.video_ids[j] for j in idx],
                             music_ids=[ix.music_ids[j] for j in idx], valid=valid)
            yield batch, meta
