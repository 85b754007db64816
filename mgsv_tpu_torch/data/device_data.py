"""Whole-dataset device residency with the batch gather on the device;
ported from mgsv_tpu/data/device_data.py.

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

Over a (dp, mp) mesh (core/mesh.py) the feature tables are split by
store row over dp and replicated over mp, each rank keeping its dp index's
1/dp of them, as JAX's dp-sharded residency (`_make_lookup`,
`_sharded_gather_program`, mgsv_tpu/data/device_data.py:84-141;
mgsv_tpu/train/loop.py:126-141).  A batch is assembled by every rank
putting the global batch's rows it holds into a zeroed buffer, and one
reduce-scatter over its dp group, JAX's psum_scatter, leaves each rank its
own rows: each row comes from one rank and zeros from the others, so the
sum is exact and the batch equals the host pipeline's bit for bit.  The
row maps and per-row metadata are small and kept whole on every rank.

`use_device_data` is the residency policy of the Trainer and the
evaluation CLI (mgsv_tpu/train/loop.py, mgsv_tpu/cli/evaluate.py): "on"
always, "off" never, "auto" on a CUDA device when one rank's share of the
stores takes less than RESIDENT_BUDGET bytes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mgsv_tpu_torch.core.mesh import Mesh, check_mesh, local_rows
from mgsv_tpu_torch.core.profiling import span
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


def use_device_data(mode: str, device, dataset: MgsvDataset, dp: int = 1) -> bool:
    """Whether `dataset` should be made resident on `device` under
    train.device_data = mode ("on" | "off" | "auto"), its tables split over
    dp ranks."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"train.device_data={mode!r}: expected 'auto', 'on' or 'off'")
    return (torch.device(device).type == "cuda"
            and dataset_device_bytes(dataset) // dp < RESIDENT_BUDGET)


def gather_batch(tree: Dict[str, torch.Tensor], idx: torch.Tensor) -> Batch:
    """The batch of dataset rows `idx` (a tensor on the tables' device),
    assembled from the resident tables (`DeviceResidentData.tree`), without
    the music codes; the span "input.gather" (core/profiling.py)."""
    with span("input.gather"):
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


def _store_share(n_rows: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(first row, rows) of a store of n_rows this rank keeps: a block of
    ceil(n_rows / dp) rows, the last rank's shorter."""
    if mesh is None:
        return 0, n_rows
    if n_rows < mesh.dp:
        raise ValueError(f"a store of {n_rows} rows cannot be split over {mesh.dp} ranks")
    per = -(-n_rows // mesh.dp)
    lo = min(mesh.dp_index * per, n_rows)
    return lo, min(per, n_rows - lo)


class DeviceResidentData:
    def __init__(self, dataset: MgsvDataset, device, mesh: Optional[Mesh] = None):
        """mesh: keep this rank's share of the feature tables, and assemble
        each batch's rows of this rank (module docstring)."""
        check_mesh(mesh)
        self.mesh = mesh
        self.index = dataset.index
        self._music_rows = np.asarray(dataset.music_rows)
        vs, ms, ix = dataset.video_store, dataset.music_store, dataset.index
        (v_lo, v_n), (m_lo, m_n) = _store_share(len(vs), mesh), _store_share(len(ms), mesh)
        self._shares = (v_lo, v_n, m_lo, m_n)
        own_v, own_m = np.arange(v_lo, v_lo + v_n), np.arange(m_lo, m_lo + m_n)
        host = {
            "vf": vs.gather("feats", own_v, dtype=None),
            "vm": vs.gather("mask", own_v, dtype=None),
            "mf": ms.gather("feats", own_m, dtype=None),
            "mm": ms.gather("mask", own_m, dtype=None),
            "video_rows": np.asarray(dataset.video_rows, np.int64),
            "music_rows": self._music_rows.astype(np.int64),
            # the host batch's arrays, dtypes unchanged
            "spans": ix.spans_target, "gt": ix.gt_moment,
            "mdur": ix.m_duration, "vdur": ix.v_duration,
        }
        self.tree = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in host.items()}
        self.device = self.tree["vf"].device          # with its index: cuda:0, not cuda

    def batch(self, idx: torch.Tensor) -> Batch:
        """The batch of dataset rows `idx` (the global batch's, a tensor on
        the device) without the music codes: all of it, or over a mesh this
        rank's rows."""
        if self.mesh is None:
            return gather_batch(self.tree, idx)
        return self._sharded_batch(idx)

    def _sharded_batch(self, idx: torch.Tensor) -> Batch:
        """Every rank contributes the rows of `idx` its tables hold, zeros
        elsewhere, packed as one buffer of the features' storage dtype (the
        features and the 0/1 masks are exact in it); one reduce-scatter
        leaves each rank its rows."""
        tree, mesh = self.tree, self.mesh
        v_lo, v_n, m_lo, m_n = self._shares
        b = idx.shape[0]
        dtype = torch.promote_types(tree["vf"].dtype, tree["mf"].dtype)

        def held(table, rows, lo, n):
            own = (rows >= lo) & (rows < lo + n)
            vals = table[(rows - lo).clamp(0, n - 1)].reshape(b, -1).to(dtype)
            return vals * own[:, None].to(dtype)

        vr, mr = tree["video_rows"][idx], tree["music_rows"][idx]
        parts = [held(tree["vf"], vr, v_lo, v_n), held(tree["vm"], vr, v_lo, v_n),
                 held(tree["mf"], mr, m_lo, m_n), held(tree["mm"], mr, m_lo, m_n)]
        buf = torch.cat(parts, dim=1)
        mine = torch.empty((b // mesh.dp, buf.shape[1]), dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter(mine, list(buf.chunk(mesh.dp)), group=mesh.dp_group)
        vf, vm, mf, mm = mine.split([p.shape[1] for p in parts], dim=1)
        rows = mine.shape[0]
        fm = vm.to(torch.float32)
        sm = mm.to(torch.float32)
        ff = vf.reshape(rows, *tree["vf"].shape[1:]).to(torch.float32) * fm[..., None]
        sf = mf.reshape(rows, *tree["mf"].shape[1:]).to(torch.float32) * sm[..., None]
        own = local_rows(idx, mesh)
        return {
            "frame_feats": ff, "frame_mask": fm,
            "segment_feats": sf, "segment_mask": sm,
            "spans_target": tree["spans"][own],
            "gt_moment": tree["gt"][own],
            "m_duration": tree["mdur"][own],
            "v_duration": tree["vdur"][own],
        }

    def __len__(self) -> int:
        return len(self.index)

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)

    def epoch_batches(
        self, batch_size: int, *, shuffle: bool, seed: int = 0, epoch: int = 0,
        drop_last: bool = True, start_batch: int = 0,
    ) -> Iterator[Tuple[Batch, BatchMeta]]:
        """As MgsvDataset.epoch_batches, the batches on the device; over a
        mesh each batch is this rank's rows (their music codes coded over
        the global batch) and its meta the global batch's."""
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
            batch = self.batch(idx_dev[i])
            batch["music_codes"] = (codes_dev[i] if self.mesh is None
                                    else local_rows(codes_dev[i], self.mesh))
            meta = BatchMeta(video_ids=[ix.video_ids[j] for j in idx],
                             music_ids=[ix.music_ids[j] for j in idx], valid=valid)
            yield batch, meta
