"""Dataset binding a CSV index to the feature stores, with epoch iterators;
ported from mgsv_tpu/data/dataset.py.

Batches are assembled on the host as numpy (one row gather per store array,
through the native gather of runtime/native.py), shuffled per epoch with a seeded permutation (the
reference's sampler.set_epoch), train drops the last partial batch and eval
pads it with a validity mask.  The index stream is the JAX package's, so
both packages see the same batches in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from mgsv_tpu_torch.data.csv_index import CsvIndex, load_csv_index
from mgsv_tpu_torch.data.feature_store import PackedFeatureStore

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass
class BatchMeta:
    video_ids: List[str]
    music_ids: List[str]
    valid: np.ndarray  # [B] bool, False on eval padding rows


def epoch_index_batches(
    n: int, batch_size: int, *, shuffle: bool, seed: int = 0, epoch: int = 0,
    drop_last: bool = True, start_batch: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields ([batch_size] int indices, [batch_size] bool valid): a seeded
    per-epoch permutation, drop_last for train, and repeat-last-row padding
    with a validity mask for eval.  start_batch skips the first k batches of
    the epoch's stream (a pure function of (seed, epoch)), which is how a
    step-granular resume replays exactly the batches an uninterrupted run
    would have seen."""
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed * 100003 + epoch).permutation(n)
    limit = (n // batch_size) * batch_size if drop_last else n
    for start in range(start_batch * batch_size, limit, batch_size):
        idx = order[start:start + batch_size]
        valid = np.ones(len(idx), bool)
        if len(idx) < batch_size and not drop_last:
            pad = batch_size - len(idx)
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        yield idx, valid


class MgsvDataset:
    def __init__(self, index: CsvIndex, video_store: PackedFeatureStore,
                 music_store: PackedFeatureStore):
        self.index = index
        self.video_store = video_store
        self.music_store = music_store
        self.video_rows = video_store.rows(index.video_ids)
        self.music_rows = music_store.rows(index.music_ids)

    @staticmethod
    def open(csv_path: str, video_store_root: str, music_store_root: str,
             max_m_duration: float = 240.0) -> "MgsvDataset":
        return MgsvDataset(load_csv_index(csv_path, max_m_duration),
                           PackedFeatureStore(video_store_root),
                           PackedFeatureStore(music_store_root))

    def __len__(self) -> int:
        return len(self.index)

    def gather(self, idx: np.ndarray) -> Tuple[Batch, BatchMeta]:
        ix = self.index
        batch = {
            "frame_feats": self.video_store.gather("feats", self.video_rows[idx]),
            "frame_mask": self.video_store.gather("mask", self.video_rows[idx]),
            "segment_feats": self.music_store.gather("feats", self.music_rows[idx]),
            "segment_mask": self.music_store.gather("mask", self.music_rows[idx]),
            "spans_target": ix.spans_target[idx],
            "gt_moment": ix.gt_moment[idx],
            "m_duration": ix.m_duration[idx],
            "v_duration": ix.v_duration[idx],
        }
        # per-batch integer codes of the music track (the ignore_same_music
        # InfoNCE branch)
        batch["music_codes"] = np.unique(
            self.music_rows[idx], return_inverse=True)[1].astype(np.int32)
        # zero the features at padded positions, whatever the stores hold
        # (dataloader_MGSV_EC_feature.py:61,67)
        batch["frame_feats"] *= batch["frame_mask"][..., None]
        batch["segment_feats"] *= batch["segment_mask"][..., None]
        meta = BatchMeta(video_ids=[ix.video_ids[i] for i in idx],
                         music_ids=[ix.music_ids[i] for i in idx],
                         valid=np.ones(len(idx), bool))
        return batch, meta

    def epoch_batches(
        self, batch_size: int, *, shuffle: bool, seed: int = 0, epoch: int = 0,
        drop_last: bool = True, start_batch: int = 0,
    ) -> Iterator[Tuple[Batch, BatchMeta]]:
        for idx, valid in epoch_index_batches(
                len(self), batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                drop_last=drop_last, start_batch=start_batch):
            batch, meta = self.gather(idx)
            meta.valid &= valid
            yield batch, meta

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_last else -(-n // batch_size)
