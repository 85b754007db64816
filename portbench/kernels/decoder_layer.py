"""Kernel #6: the DETR decoder layer with `fused_decoder`
(csrc/fused_decoder_layer.cu, csrc/fused_decoder_layer_bwd.cu).  No cell of
the benchmark routes to it yet (the Trainer runs the plain decoder), so its
launches are named and its least work is not counted: a cell that takes it
adds its count here."""

NAMES = ("attention_rows_bwd_kernel", "cross_attention_kernel")


def least_s(ctx) -> float:
    return 0.0
