"""Packed memory-mapped feature store (the port's copy of the JAX package's
`mgsv_tpu/data/feature_store.py`, same on-disk format), and the one-time
converter from a reference feature directory (`vit_feature/{id}.pt` etc.)
into a packed store.

Store layout (directory):
    meta.json       {"ids": [...], "arrays": {name: {"shape": ..., "dtype": ...}}}
    <name>.npy      one per array, shape [N, ...]
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np


class PackedFeatureStore:
    """Immutable id -> row feature store.  use_native (the default) gathers
    rows through the native library (runtime/native.py: mmap plus a threaded
    copy that widens float16 to float32 in the same pass) and raises when
    that library cannot be built or loaded; use_native=False reads numpy
    memmaps."""

    def __init__(self, root: str, use_native: bool = True):
        self.root = root
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        self.ids: List[str] = meta["ids"]
        self.row_of: Dict[str, int] = {i: r for r, i in enumerate(self.ids)}
        self.arrays: Dict[str, Any] = {}
        for name, spec in meta["arrays"].items():
            path = os.path.join(root, f"{name}.npy")
            if use_native:
                from mgsv_tpu_torch.runtime.native import NativeStore
                self.arrays[name] = NativeStore(path, spec["shape"], spec["dtype"])
            else:
                self.arrays[name] = np.load(path, mmap_mode="r")

    def __len__(self) -> int:
        return len(self.ids)

    def rows(self, ids: Sequence[str]) -> np.ndarray:
        return np.asarray([self.row_of[i] for i in ids], dtype=np.int64)

    def gather(self, name: str, row_idx: np.ndarray,
               dtype: Optional[np.dtype] = np.float32) -> np.ndarray:
        """Rows `row_idx` of array `name` as dtype (None: the storage dtype)."""
        arr = self.arrays[name]
        if not isinstance(arr, np.ndarray):
            return arr.gather(row_idx, out_dtype=dtype)
        out = arr[row_idx]
        return out.astype(dtype) if dtype is not None else np.asarray(out)

    def prefetch(self, name: str, row_idx: np.ndarray) -> None:
        """Ask the OS to read the pages of rows `row_idx` ahead (native
        stores; the memmap leaves it to the page cache's readahead)."""
        arr = self.arrays[name]
        if not isinstance(arr, np.ndarray):
            arr.prefetch(row_idx)

    @staticmethod
    def build(root: str, ids: Sequence[str],
              arrays: Mapping[str, np.ndarray]) -> "PackedFeatureStore":
        os.makedirs(root, exist_ok=True)
        meta = {"ids": list(ids), "arrays": {}}
        for name, arr in arrays.items():
            if arr.shape[0] != len(ids):
                raise ValueError(f"{name}: {arr.shape[0]} rows for {len(ids)} ids")
            np.save(os.path.join(root, f"{name}.npy"), arr)
            meta["arrays"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump(meta, f)
        return PackedFeatureStore(root)


def convert_reference_features(
    feature_dir: str,
    mask_dir: str,
    ids: Sequence[str],
    out_root: str,
    feature_name: str = "feats",
    mask_name: str = "mask",
    feature_dtype=np.float16,
) -> PackedFeatureStore:
    """One-time packer: reference per-id .pt files -> packed store.

    feature_dir/{id}.pt  (e.g. features/Kuai_feature/vit_feature1/vit_feature)
    mask_dir/{id}.pt     (e.g. .../vit_mask)
    Deduplicates ids (multiple CSV rows share music ids).
    """
    import torch

    uniq = list(dict.fromkeys(ids))
    feats, masks = [], []
    for i in uniq:
        f = torch.load(os.path.join(feature_dir, f"{i}.pt"), map_location="cpu")
        m = torch.load(os.path.join(mask_dir, f"{i}.pt"), map_location="cpu")
        feats.append(f.detach().to(torch.float32).numpy().astype(feature_dtype))
        masks.append(m.detach().to(torch.uint8).numpy())
    return PackedFeatureStore.build(
        out_root, uniq,
        {feature_name: np.stack(feats), mask_name: np.stack(masks)},
    )
