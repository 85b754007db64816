"""Operation and byte counts, and the card's peaks: the benchmark's frozen
copies, so that a change to the program cannot change its yardstick.

`forward_flops` / `train_step_flops` are a copy of the port's
mgsv_tpu_torch/core/flops.py (itself a copy of the JAX package's), reading
the benchmark's flat configuration: 2*M*N*K per GEMM over MaDe's forward,
times 3 for a training step; elementwise work, the matcher and the
optimizer left out.  `serve_query_flops` counts an engine query the same
way, and `eval_pass_flops` one evaluation of a split.  The kernel counts
(`encoder_flops`, `temporal_flops`, `xpool_pair_flops`) and `least_s` are
copies of chip_smoke.py's.
"""

from __future__ import annotations

from typing import Dict

# H100 SXM, NVIDIA's data sheet, dense: bf16, TF32 (what the float32
# kernels' 3xTF32 products run on) and HBM3.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_HBM_BYTES = 3.35e12


class _View:
    """cfg["model.x"] as m.x."""

    def __init__(self, cfg: dict, section: str):
        self._cfg, self._section = cfg, section

    def __getattr__(self, key):
        return self._cfg[f"{self._section}.{key}"]


def _attention_flops(b: int, lq: int, lkv: int, d: int) -> float:
    """scores (q@k^T) + context (p@v): 2 * [Lq, D] x [D, Lkv] GEMM pairs."""
    return 2.0 * (2.0 * b * lq * lkv * d)


def _temporal_tower_flops(b: int, l: int, d: int, mlp: int, d_in: int) -> float:
    """proj d_in->d, then a temporal transformer of depth 1 (QKV, attention,
    out, FFN) and its final Linear."""
    proj = 2.0 * b * l * d_in * d
    qkv = 2.0 * b * l * d * (3 * d)
    attn = _attention_flops(b, l, l, d)
    out = 2.0 * b * l * d * d
    ffn = 2.0 * (2.0 * b * l * d * mlp)
    final = 2.0 * b * l * d * d
    return proj + qkv + attn + out + ffn + final


def forward_flops(cfg: dict, batch_size: int) -> Dict[str, float]:
    """Per-component forward matmul FLOPs at the given batch size."""
    b = batch_size
    m = _View(cfg, "model")
    d = m.dim_input
    f = cfg["data.max_v_frames"]
    s = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    l = f + s                                    # concat fusion length

    comp: Dict[str, float] = {}
    comp["video_tower"] = _temporal_tower_flops(b, f, d, m.temporal_mlp_dim, cfg["data.vit_dim"])
    comp["audio_tower"] = _temporal_tower_flops(b, s, d, m.temporal_mlp_dim, cfg["data.ast_dim"])

    # X-Pool: shared-LN q/k/v projections once per row, then the per-(music,
    # video) pair stage (scores [S], context, Wout, Wlin) over b*b pairs
    xpool_proj = 2.0 * b * d * d + 2.0 * (2.0 * b * s * d * d)
    per_pair = _attention_flops(1, 1, s, d) + 2.0 * (2.0 * d * d)
    comp["xpool"] = xpool_proj + b * b * per_pair

    # DETR encoder layers
    enc = (2.0 * b * l * d * (3 * d)              # q/k/v
           + _attention_flops(b, l, l, d)
           + 2.0 * b * l * d * d                  # out proj
           + 2.0 * (2.0 * b * l * d * m.detr_ffn_dim))
    comp["detr_encoder"] = m.detr_enc_layers * enc

    # DETR decoder layers at num_moment_queries queries, dominated by the
    # K/V projections over the L-token memory
    nq = m.num_moment_queries
    dec = (2.0 * b * nq * d * d                   # q proj
           + 2.0 * (2.0 * b * l * d * d)          # k/v proj over memory
           + _attention_flops(b, nq, l, d)
           + 2.0 * b * nq * d * d                 # out proj
           + 2.0 * (2.0 * b * nq * d * m.detr_ffn_dim))
    if m.decoder_self_attn:
        dec += (2.0 * b * nq * d * (3 * d) + _attention_flops(b, nq, nq, d)
                + 2.0 * b * nq * d * d)
    comp["detr_decoder"] = m.detr_dec_layers * dec

    # heads on all decoder layers
    nl = m.detr_dec_layers
    heads = (2.0 * nl * b * nq * d * 2            # class_embed
             + 3.0 * (2.0 * nl * b * nq * d * d)  # span MLP (3 layers)
             + 2.0 * nl * b * nq * d * m.contrastive_dim
             + 2.0 * b * f * d * m.contrastive_dim)  # proj_vid_mem
    comp["heads"] = heads
    return comp


def train_step_flops(cfg: dict, batch_size: int) -> Dict[str, float]:
    """Total analytic FLOPs: forward and fwd+bwd (3x matmul rule)."""
    comp = forward_flops(cfg, batch_size)
    fwd = sum(comp.values())
    return {"forward": fwd, "train_step": 3.0 * fwd, "components": comp}


def serve_query_flops(cfg: dict, batch: int, candidates: int, tracks: int) -> float:
    """One engine query over `batch` padded videos: the video tower, the dual
    and X-Pool scores against `tracks` index tracks (the q projection once
    per video, k and v once per track and block, the pair stage per pair),
    and the DETR and heads over batch * candidates pairs."""
    m = _View(cfg, "model")
    d, f = m.dim_input, cfg["data.max_v_frames"]
    s = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    video = _temporal_tower_flops(batch, f, d, m.temporal_mlp_dim, cfg["data.vit_dim"])
    scan = 2.0 * batch * tracks * d + 2.0 * batch * d * d + 2.0 * (2.0 * tracks * s * d * d) \
        + batch * tracks * (_attention_flops(1, 1, s, d) + 2.0 * (2.0 * d * d))
    pairs = forward_flops(cfg, batch * candidates)
    return video + scan + pairs["detr_encoder"] + pairs["detr_decoder"] + pairs["heads"]


def eval_pass_flops(cfg: dict, rows: int, batch: int) -> Dict[str, float]:
    """One evaluation of `rows` rows at `batch` (eval/evaluator.py::evaluate):
    the forward of every batch, the last padded to `batch`, and the corpus
    similarity over the split: the dual cosine [N, N], X-Pool's q projection
    once per video and its k and v once per snippet of each track, and the
    pair chain (`xpool_pair_flops`, Wout once per snippet)."""
    m = _View(cfg, "model")
    d = m.dim_input
    s = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    forward = -(-rows // batch) * sum(forward_flops(cfg, batch).values())
    corpus = (2.0 * rows * rows * d + 2.0 * rows * d * d + 2.0 * (2.0 * rows * s * d * d)
              + xpool_pair_flops(rows, rows, s, d))
    return {"forward": forward, "corpus": corpus, "pass": forward + corpus}


def encoder_flops(b: int, length: int, d: int, ffn: int) -> int:
    """One encoder layer's forward: QKV, scores and P.V, out-projection, FFN."""
    rows = b * length
    return (2 * rows * d * 3 * d + 4 * b * length * length * d + 2 * rows * d * d
            + 4 * rows * d * ffn)


def temporal_flops(b: int, length: int, d: int, ffn: int) -> int:
    """One temporal layer's forward: QKV and out-projection (8 L D^2),
    scores and P.V (4 L^2 D), FFN (4 L D F), per batch row."""
    return b * (8 * length * d * d + 4 * length * length * d + 4 * length * d * ffn)


def xpool_pair_flops(vc: int, mc: int, s: int, d: int) -> int:
    """The least work of the X-Pool pair chain: per (video, track) the
    scores and p.u (4 S D), Wlin (2 D^2) and the cosine (2 D); Wout once per
    snippet of each track (M S 2 D^2)."""
    return vc * mc * (4 * s * d + 2 * d * d + 2 * d) + mc * s * 2 * d * d


def least_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time of a call: the larger of its operations at the peak
    of `precision` ("bf16" | "tf32") and its bytes (inputs read once,
    outputs written once) at the HBM rate."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_HBM_BYTES)
