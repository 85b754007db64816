"""Index CLI of the PyTorch port: build a music index from a feature store
and a reference-format checkpoint, query it, or serve it over HTTP/JSON.

    # build
    python -m mgsv_tpu_torch.cli.index build --ckpt made.bin \
        --music-store features/packed/music_store --out index.npz

    # query with a video from a store
    python -m mgsv_tpu_torch.cli.index query --ckpt made.bin \
        --index index.npz --video-store features/packed/video_store \
        --video-id 113722188340 --top-k 5

    # serve the index over HTTP (GET /healthz, POST /query)
    python -m mgsv_tpu_torch.cli.index serve --ckpt made.bin \
        --index index.npz --port 8008

`--ckpt` is a `.bin` as `python -m mgsv_tpu.cli.evaluate --export-torch`
or the reference writes it; config overrides (`--model.dim_input 256`, ...)
follow the JAX CLIs.  The index `.npz` format is shared with
`python -m mgsv_tpu.cli.index`.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from mgsv_tpu.cli.train import parse_kv_overrides
from mgsv_tpu.config import Config
from mgsv_tpu.data.feature_store import PackedFeatureStore
from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.interop.from_jax import load_reference_bin
from mgsv_tpu_torch.serve.engine import MusicIndex, RetrievalEngine, build_music_index


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser("mgsv-torch-index")
    parser.add_argument("command", choices=["build", "query", "serve"])
    parser.add_argument("--ckpt", required=True,
                        help="reference-format .bin checkpoint")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--music-store", default=None)
    parser.add_argument("--video-store", default=None)
    parser.add_argument("--index", default="index.npz")
    parser.add_argument("--out", default="index.npz")
    parser.add_argument("--video-id", default=None)
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument(
        "--index-dtype", default="float32", choices=["float32", "bfloat16"],
        help="query/serve: dtype of the device-resident token store")
    parser.add_argument(
        "--warmup", default="1,2,4,8,16,32",
        help="serve: comma-separated batch buckets to run once before "
             "accepting traffic ('' disables)")
    known, rest = parser.parse_known_args(argv)
    cfg = Config.from_overrides(parse_kv_overrides(rest))
    device = resolve_device(known.device)
    model = load_reference_bin(known.ckpt, cfg).to(device).eval()

    if known.command == "build":
        store = PackedFeatureStore(known.music_store)
        rows = np.arange(len(store))
        index = build_music_index(model, store.ids, store.gather("feats", rows),
                                  store.gather("mask", rows))
        index.save(known.out)
        print(json.dumps({"tracks": len(index.music_ids), "path": known.out}))
        return

    engine = RetrievalEngine(model, cfg, MusicIndex.load(known.index),
                             index_dtype=known.index_dtype)

    if known.command == "serve":
        from mgsv_tpu.serve.server import RetrievalServer
        if known.warmup:
            engine.warmup(batch_sizes=[int(x) for x in known.warmup.split(",") if x],
                          top_k=known.top_k)
        RetrievalServer(engine, host=known.host, port=known.port,
                        model_name=cfg.train.name).serve_forever()
        return

    store = PackedFeatureStore(known.video_store)
    vid = known.video_id or store.ids[0]
    row = store.rows([vid])
    results = engine.query(store.gather("feats", row), store.gather("mask", row),
                           top_k=known.top_k)
    print(json.dumps({"video_id": vid, **results[0]}, indent=2))


if __name__ == "__main__":
    main()
