"""Launches shared by the port's layer kernels: the wgmma GEMM core
(csrc/wgmma_gemm.cuh) and the LayerNorm, dropout, reduction and
tensor-core attention launches of csrc/layer_bwd_kernels.cuh.  Their time
counts as the port's; their least work is counted with the layer kernel
whose call launched them."""

NAMES = ("wg_gemm_kernel", "add_kernel", "attention_bwd_tc_kernel", "attention_fwd_tc_kernel",
         "colsum_kernel", "dropout_kernel", "ln_bwd_sum_kernel", "ln_fwd_kernel",
         "reduce_kernel", "reduce_wb_kernel", "sum_blocks_kernel")


def least_s(ctx) -> float:
    return 0.0
