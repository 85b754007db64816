"""Kernels #3 and #4: the X-Pool pooled similarity, training forward and
backward and the evaluation scan (csrc/xpool_sim_train.cu).  Counts as
chip_smoke.py's: the pair chain's least work (`xpool_pair_flops`), the
backward twice it; bytes of q, k, v, the mask, vhat, the stage's weights
and the [M, V] similarities (the backward also their gradients)."""

from portbench.flops import least_s as bound, xpool_pair_flops

NAMES = ("xpool_pair_kernel", "head_bwd_kernel", "softmax_bwd_rows_kernel",
         "softmax_rows_kernel", "split_tf32_kernel", "split_wlin_kernel")
FORWARD = "mgsv_tpu_torch.ops.cuda.xpool_sim:xpool_sim_fwd"
BACKWARD = "mgsv_tpu_torch.ops.cuda.xpool_sim:xpool_sim_bwd"


def least_s(ctx) -> float:
    fwd_calls, bwd_calls = ctx.launches(FORWARD), ctx.launches(BACKWARD)
    if not fwd_calls:
        return 0.0
    b, s, d = ctx.batch, ctx.dim("s"), ctx.dim("d")
    flops = xpool_pair_flops(b, b, s, d)
    ins = (2 * b * d + 2 * b * s * d + b * s + 2 * d * d + 6 * d) * 4
    fwd = bound(flops, ins + b * b * 4, "tf32")
    bwd = bound(2 * flops, 2 * ins + b * b * 4, "tf32")
    return fwd_calls * fwd + bwd_calls * bwd
