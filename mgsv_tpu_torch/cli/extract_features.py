"""Feature extraction CLI of the PyTorch port:
`python -m mgsv_tpu_torch.cli.extract_features`.

Raw media -> packed feature stores, ported from
mgsv_tpu/cli/extract_features.py: decode on the host (per-second JPEG
frames, WAV tracks -> kaldi fbank snippets), encode with the frozen CLIP
ViT-B/32 and AST towers on the device at large batch, write the packed
`video_store` / `music_store` (float16 features, uint8 masks) that the
training pipeline gathers from.

    python -m mgsv_tpu_torch.cli.extract_features \\
      --csv dataset/MGSV-EC/val_data.csv \\
      --frames-root /data/frames --audio-root /data/music \\
      --clip-ckpt ViT-B-32.pt --ast-ckpt audioset_0.4593.pth \\
      --out features/packed

`--convert-from features/Kuai_feature` packs an existing reference feature
directory without any forward.  `--num-shards N --shard-index i` extracts
one chunk-aligned share of the work into {out}/shard_i, and
`--merge-shards N` concatenates the shards into stores byte-identical to a
single-process run.  `--device` (default cuda) takes the place of the JAX
CLI's --platform / --cpu-devices; `--data.*` overrides set the geometry.
"""

from __future__ import annotations

import argparse
import glob
import logging
import math
import os
import time

import numpy as np
import torch

logger = logging.getLogger("mgsv_tpu_torch.extract")


def _load_clip_tower(path: str):
    """A ClipVisionTower with the checkpoint's weights, its geometry
    inferred from the checkpoint (width and patch from conv1, depth from
    the resblock count, out_dim from proj, image grid from the positional
    embedding, heads by CLIP's 64-wide heads: ViT-B/32 is 768/12/12)."""
    from mgsv_tpu_torch.models.clip_vit import ClipVisionTower, import_clip_visual_state_dict

    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.state_dict() if hasattr(blob, "state_dict") else blob
    s = import_clip_visual_state_dict({k: v.float() for k, v in state.items()
                                       if isinstance(v, torch.Tensor)})
    depth = 1 + max(int(k.split(".")[2]) for k in s if k.startswith("transformer.resblocks."))
    width, _, patch, _ = s["conv1.weight"].shape
    grid = math.isqrt(s["positional_embedding"].shape[0] - 1)
    tower = ClipVisionTower(width=width, depth=depth, heads=max(1, width // 64), patch=patch,
                            out_dim=s["proj"].shape[1], image_size=grid * patch)
    tower.load_state_dict(s, strict=True)
    return tower


def _load_ast_encoder(path: str, dcfg):
    """An ASTEncoder with the checkpoint's weights: embed dim, depth and
    label dim from the checkpoint (heads by timm's 64-wide heads: the
    audioset AST is 768/12/12), the input geometry from the data config,
    which must match the checkpoint's positional embedding."""
    from mgsv_tpu_torch.models.ast import ASTEncoder, import_ast_state_dict, patch_grid

    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    s = import_ast_state_dict({k: v.float().numpy() for k, v in state.items()})
    depth = 1 + max(int(k.split(".")[2]) for k in s if k.startswith("v.blocks."))
    embed_dim = s["v.patch_embed.proj.weight"].shape[0]
    label_dim = s["mlp_head.1.weight"].shape[0] if "mlp_head.1.weight" in s else 527
    enc = ASTEncoder(embed_dim=embed_dim, depth=depth, heads=max(1, embed_dim // 64),
                     label_dim=label_dim, input_fdim=dcfg.mel_bins,
                     input_tdim=dcfg.target_length)
    # The checkpoint's pos_embed grid is fixed while the encoder geometry
    # comes from --data.* overrides: say so, rather than fail on a shape.
    f_dim, t_dim = patch_grid(enc.fstride, enc.tstride, dcfg.mel_bins, dcfg.target_length)
    want, have = f_dim * t_dim + 2, s["v.pos_embed"].shape[1]
    if have != want:
        raise ValueError(
            f"AST geometry mismatch: --data.mel_bins={dcfg.mel_bins} / "
            f"--data.target_length={dcfg.target_length} imply a "
            f"{f_dim}x{t_dim} patch grid ({want} pos-embed tokens incl. "
            f"cls/dist), but the checkpoint {path!r} carries {have}; use the "
            "geometry the checkpoint was trained at (reference default: "
            "128 mel bins x 1024 frames -> 12x101 grid, 1214 tokens)")
    enc.load_state_dict(s, strict=True)
    return enc


def _audio_path(root: str, mid: str) -> str:
    """A track id's audio file, found by extension, so compressed formats
    reach the decoder hook (data/media.py::register_audio_decoder)."""
    wav = os.path.join(root, f"{mid}.wav")
    if os.path.exists(wav):
        return wav
    hits = sorted(glob.glob(os.path.join(glob.escape(root), glob.escape(mid) + ".*")))
    if not hits:
        raise FileNotFoundError(f"no audio file for track {mid!r} in {root}")
    return hits[0]


def _shard_chunks(items, chunk_size: int, shard_index: int, num_shards: int):
    """The shard's contiguous share of a work list, cut at encode-batch
    chunks, so every chunk a shard encodes is the chunk a single-process
    run encodes (the merged stores are then byte-identical without relying
    on batch-size-invariant encoder numerics).  Keeps the global order."""
    chunks = [items[i:i + chunk_size] for i in range(0, len(items), chunk_size)]
    lo = shard_index * len(chunks) // num_shards
    hi = (shard_index + 1) * len(chunks) // num_shards
    return [x for c in chunks[lo:hi] for x in c]


def extract(args, dcfg) -> dict:
    """Encode this shard's videos and tracks into packed stores; returns
    the counts ("videos", "tracks") and, per half ("video", "music"), the
    host frontend's seconds (decode, resample, fbank, preprocessing) and
    the encoders' (from the copy to the device to the features back on the
    host): "video_host_seconds", "video_device_seconds", ..."""
    from mgsv_tpu_torch.core.device import resolve_device
    from mgsv_tpu_torch.data.audio import extract_snippets, resample_sinc
    from mgsv_tpu_torch.data.csv_index import load_csv_index
    from mgsv_tpu_torch.data.feature_store import PackedFeatureStore
    from mgsv_tpu_torch.data.frames import load_clip_frames
    from mgsv_tpu_torch.data.media import load_audio
    from mgsv_tpu_torch.models.frozen import FrozenEncoders

    device = resolve_device(args.device)          # raises for cuda without a card
    index = load_csv_index(args.csv, dcfg.max_m_duration)
    enc = FrozenEncoders(_load_clip_tower(args.clip_ckpt), _load_ast_encoder(args.ast_ckpt, dcfg),
                         device)

    shards = max(1, args.num_shards)
    shard = args.shard_index or 0
    if not 0 <= shard < shards:
        raise SystemExit(f"--shard-index {shard} out of range for --num-shards {shards}")
    out_root = args.out if shards == 1 else os.path.join(args.out, f"shard_{shard}")
    seconds = dict.fromkeys(("video_host_seconds", "video_device_seconds",
                             "music_host_seconds", "music_device_seconds"), 0.0)

    # ---- video frames: the CSV's per-row window [video_start, video_end]
    window_of = {}
    for vid, s, e in zip(index.video_ids, index.video_start, index.video_end):
        window_of.setdefault(vid, (float(s), float(e)))
    uniq_videos = list(dict.fromkeys(index.video_ids))
    my_videos = _shard_chunks(uniq_videos, args.batch, shard, shards)
    feats, masks = [], []
    for i in range(0, len(my_videos), args.batch):
        chunk = my_videos[i:i + args.batch]
        t0 = time.perf_counter()
        frames, fmask = [], []
        for vid in chunk:
            start_s, end_s = window_of[vid]
            fr, mk = load_clip_frames(os.path.join(args.frames_root, vid), start_s, end_s,
                                      dcfg.max_v_frames, dcfg.image_resolution)
            frames.append(fr)
            fmask.append(mk)
        t1 = time.perf_counter()
        feats.append(enc.encode_frames(np.stack(frames)).cpu().numpy().astype(np.float16))
        masks.append(np.stack(fmask).astype(np.uint8))
        seconds["video_host_seconds"] += t1 - t0
        seconds["video_device_seconds"] += time.perf_counter() - t1
        logger.info("video %d/%d", i + len(chunk), len(my_videos))
    if my_videos:
        PackedFeatureStore.build(os.path.join(out_root, "video_store"), my_videos,
                                 {"feats": np.concatenate(feats), "mask": np.concatenate(masks)})

    # ---- audio snippets: one AST batch holds batch // 8 tracks' snippets
    music_chunk = max(1, args.batch // 8)
    uniq_music = list(dict.fromkeys(index.music_ids))
    my_music = _shard_chunks(uniq_music, music_chunk, shard, shards)
    feats, masks = [], []
    for i in range(0, len(my_music), music_chunk):
        chunk = my_music[i:i + music_chunk]
        t0 = time.perf_counter()
        specs, smask = [], []
        for mid in chunk:
            wav, sr = load_audio(_audio_path(args.audio_root, mid))
            wav = resample_sinc(wav, sr, dcfg.sample_rate)
            sp, mk = extract_snippets(wav, dcfg.sample_rate, dcfg.max_m_duration, dcfg.stride,
                                      dcfg.filter_sec, dcfg.padding_sec, dcfg.mel_bins,
                                      dcfg.target_length)
            specs.append(sp)
            smask.append(mk)
        t1 = time.perf_counter()
        feats.append(enc.encode_snippets(np.stack(specs)).cpu().numpy().astype(np.float16))
        masks.append(np.stack(smask).astype(np.uint8))
        seconds["music_host_seconds"] += t1 - t0
        seconds["music_device_seconds"] += time.perf_counter() - t1
        logger.info("music %d/%d", i + len(chunk), len(my_music))
    if my_music:
        PackedFeatureStore.build(os.path.join(out_root, "music_store"), my_music,
                                 {"feats": np.concatenate(feats), "mask": np.concatenate(masks)})
    return {"videos": len(my_videos), "tracks": len(my_music), **seconds}


def merge_shards(args) -> None:
    """Concatenate {out}/shard_{0..N-1} stores into {out}/{video,music}_store.

    Shards hold contiguous chunk-aligned slices in global order, so plain
    concatenation reproduces the single-process store byte for byte.  A
    shard directory may lack a store when there were fewer work chunks
    than shards: skipped, not an error.
    """
    from mgsv_tpu_torch.data.feature_store import PackedFeatureStore

    for store_name in ("video_store", "music_store"):
        ids, feats, masks = [], [], []
        for k in range(args.merge_shards):
            root = os.path.join(args.out, f"shard_{k}", store_name)
            if not os.path.isdir(root):
                continue
            st = PackedFeatureStore(root, use_native=False)
            rows = np.arange(len(st))
            ids.extend(st.ids)
            feats.append(st.gather("feats", rows, dtype=None))
            masks.append(st.gather("mask", rows, dtype=None))
        if not ids:
            raise SystemExit(f"--merge-shards found no {store_name} under {args.out}/shard_*")
        if len(set(ids)) != len(ids):
            raise SystemExit(f"duplicate ids across {store_name} shards: shards must come "
                             "from the same CSV and disjoint --shard-index values")
        PackedFeatureStore.build(os.path.join(args.out, store_name), ids,
                                 {"feats": np.concatenate(feats), "mask": np.concatenate(masks)})
        logger.info("merged %d shard stores -> %s (%d ids)", args.merge_shards, store_name,
                    len(ids))


def convert(args, dcfg) -> None:
    """Reference .pt feature directories -> packed stores (no forward)."""
    from mgsv_tpu_torch.data.csv_index import load_csv_index
    from mgsv_tpu_torch.data.feature_store import convert_reference_features

    index = load_csv_index(args.csv, dcfg.max_m_duration)
    src = args.convert_from
    convert_reference_features(os.path.join(src, "vit_feature1", "vit_feature"),
                               os.path.join(src, "vit_feature1", "vit_mask"),
                               index.video_ids, os.path.join(args.out, "video_store"))
    convert_reference_features(os.path.join(src, "ast_feature2p5", "ast_feature"),
                               os.path.join(src, "ast_feature2p5", "ast_mask"),
                               index.music_ids, os.path.join(args.out, "music_store"))


def main(argv=None):
    """Returns extract()'s counts and seconds for an extraction, else None."""
    from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
    from mgsv_tpu_torch.config import Config

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser("mgsv-torch-extract-features")
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--frames-root", default=None)
    p.add_argument("--audio-root", default=None)
    p.add_argument("--clip-ckpt", default=None)
    p.add_argument("--ast-ckpt", default=None)
    p.add_argument("--convert-from", default=None,
                   help="reference feature root (e.g. features/Kuai_feature)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num-shards", type=int, default=1,
                   help="this invocation extracts 1/N of the work into {out}/shard_{i}")
    p.add_argument("--shard-index", type=int, default=None, help="which shard this one is")
    p.add_argument("--merge-shards", type=int, default=0,
                   help="merge {out}/shard_{0..N-1} stores into {out} (byte-identical to "
                        "a single-process extraction) and exit")
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(argv)
    overrides = parse_kv_overrides(rest)
    bad = [k for k in overrides if not k.startswith("data.")]
    if bad:
        raise SystemExit(f"extract_features only takes --data.* overrides, got {bad}")
    dcfg = Config.from_overrides(overrides).data
    if args.merge_shards:
        merge_shards(args)
        return None
    if args.convert_from:
        convert(args, dcfg)
        return None
    if not all([args.frames_root, args.audio_root, args.clip_ckpt, args.ast_ckpt]):
        raise SystemExit("need --frames-root --audio-root --clip-ckpt --ast-ckpt "
                         "(or --convert-from)")
    return extract(args, dcfg)


if __name__ == "__main__":
    main()
