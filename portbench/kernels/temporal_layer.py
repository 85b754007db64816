"""Kernel #5: the temporal tower's layer with `fused_temporal`, forward
(csrc/fused_temporal_layer.cu) and backward (csrc/fused_temporal_layer_bwd.cu),
float32.  A training step runs one call a tower: the snippets' (L = S) and
the frames' (L = F).  Counts as chip_smoke.py's `temporal_flops`, the
backward twice it; bytes of x, the mask, the output and the weights (the
backward also the gradients)."""

from portbench.flops import least_s as bound, temporal_flops

NAMES = ("attention_bwd_wg_kernel",)
FORWARD = "mgsv_tpu_torch.ops.cuda.fused_temporal_layer:fused_temporal_layer"
BACKWARD = "mgsv_tpu_torch.ops.cuda.fused_temporal_layer:fused_temporal_layer_bwd"


def least_s(ctx) -> float:
    fwd_calls, bwd_calls = ctx.launches(FORWARD), ctx.launches(BACKWARD)
    if not fwd_calls:
        return 0.0
    b, d, mlp = ctx.batch, ctx.dim("d"), ctx.dim("mlp")
    params = (4 * d * d + 2 * d * mlp + 8 * d + mlp) * 4
    total = 0.0
    for length in (ctx.dim("s"), ctx.dim("f")):
        flops = temporal_flops(b, length, d, mlp)
        act = b * length * d * 4
        fwd = bound(flops, 2 * act + b * length * 4 + params, "tf32")
        bwd = bound(2 * flops, 4 * act + b * length * 4 + 2 * params, "tf32")
        total += fwd_calls / 2 * fwd + bwd_calls / 2 * bwd
    return total
