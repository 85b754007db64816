"""Kernel #4: the X-Pool similarity of an evaluation's corpus
(ops/cuda/xpool_sim.py::xpool_sim_eval: csrc/xpool_sim_train.cu's forward
at rate 0, `xpool_pair_kernel<false>`, whose launches kernels/xpool_sim.py
names).  One call a pass, over V = M = the mix's `rows`.  Counts as
chip_smoke.py's: the pair chain's least work (`xpool_pair_flops`); bytes of
q, vhat, k, v, the mask, the stage's weights and the [M, V] similarities,
float32."""

from portbench.flops import least_s as bound, xpool_pair_flops

NAMES = ()
FORWARD = "mgsv_tpu_torch.ops.cuda.xpool_sim:xpool_sim_eval"


def least_s(ctx) -> float:
    calls = ctx.launches(FORWARD)
    if not calls:
        return 0.0
    n, s, d = ctx.cell.traffic.get("rows", 0), ctx.dim("s"), ctx.dim("d")
    if calls != ctx.trace_units or not n:
        return float("nan")
    ins = (2 * n * d + 2 * n * s * d + n * s + 2 * d * d + 6 * d) * 4
    return calls * bound(xpool_pair_flops(n, n, s, d), ins + n * n * 4, "tf32")
