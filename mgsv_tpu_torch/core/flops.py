"""Analytic matmul FLOP count of the MaDe training step, and the card's
peak rates; the count is a copy of mgsv_tpu/core/flops.py's (held equal to
it in tests/test_torch_port_copies.py).

Counts are constants of the configuration: 2*M*N*K per GEMM over the
forward graph of MaDe at the configured widths (towers -> X-Pool -> DETR ->
heads), times 3 for a training step (each GEMM differentiates into two of
the same size).  Elementwise, softmax and LayerNorm work, the matcher and
the optimizer are left out, so a share of the peak read from this count is
slightly conservative.
"""

from __future__ import annotations

from typing import Dict, Optional

from mgsv_tpu_torch.config import Config


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


def forward_flops(cfg: Config, batch_size: int) -> Dict[str, float]:
    """Per-component forward matmul FLOPs at the given batch size."""
    b = batch_size
    m = cfg.model
    d = m.dim_input
    f = cfg.data.max_v_frames
    s = cfg.data.max_snippet_num
    l = f + s                                    # concat fusion length

    comp: Dict[str, float] = {}
    comp["video_tower"] = _temporal_tower_flops(b, f, d, m.temporal_mlp_dim, cfg.data.vit_dim)
    comp["audio_tower"] = _temporal_tower_flops(b, s, d, m.temporal_mlp_dim, cfg.data.ast_dim)

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


def train_step_flops(cfg: Config, batch_size: int) -> Dict[str, float]:
    """Total analytic FLOPs: forward and fwd+bwd (3x matmul rule)."""
    comp = forward_flops(cfg, batch_size)
    fwd = sum(comp.values())
    return {"forward": fwd, "train_step": 3.0 * fwd, "components": comp}


# Dense tensor-core peaks in TFLOP/s by torch.cuda.get_device_name(), from
# the card's data sheet: bf16, and TF32 for float32 (what the kernels'
# 3xTF32 products run on); the bounds of PERF.md section 6 use the same.
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.0, "float32": 495.0},
}


def peak_tflops(device_name: str, dtype: str = "bfloat16") -> Optional[float]:
    """The card's dense peak for `dtype` ("bfloat16" | "float32"); None for
    a card or a type the table does not hold."""
    return _PEAK_TFLOPS.get(device_name, {}).get(dtype)
