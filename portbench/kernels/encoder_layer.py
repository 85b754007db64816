"""Kernels #1 and #2: the post-norm DETR encoder layer's forward
(csrc/fused_encoder_layer.cu) and backward (csrc/fused_encoder_layer_bwd.cu).
Counts as chip_smoke.py's: the forward's QKV, scores and P.V,
out-projection and FFN; the backward twice that, the recompute left out;
bytes of x, pos, mask, the output and the weights (the backward also the
incoming and outgoing gradients), float32."""

from portbench.flops import encoder_flops, least_s as bound

NAMES = ("attention_kernel",)
FORWARD = "mgsv_tpu_torch.ops.cuda.fused_encoder_layer:fused_encoder_layer"
BACKWARD = "mgsv_tpu_torch.ops.cuda.fused_encoder_layer:fused_encoder_layer_bwd"


def least_s(ctx) -> float:
    d, ffn, length = ctx.dim("d"), ctx.dim("ffn"), ctx.dim("detr_len")
    params = 4 * d * d + 2 * d * ffn + 9 * d + ffn
    precision = ctx.detr_precision
    layers = ctx.dim("enc")
    fwd_calls, bwd_calls = ctx.launches(FORWARD), ctx.launches(BACKWARD)
    total, calls = 0.0, 0
    for rows in ctx.detr_rows:
        flops = encoder_flops(rows, length, d, ffn)
        act = rows * length * d * 4
        fwd = bound(flops, 3 * act + rows * length * 4 + params * 4, precision)
        bwd = bound(2 * flops, 6 * act + rows * length * 4 + 2 * params * 4, precision)
        total += layers * fwd + (layers * bwd if bwd_calls else 0.0)
        calls += layers
    if calls != fwd_calls or bwd_calls not in (0, fwd_calls):
        return float("nan")
    return total
