"""Kernel #7: the frozen towers' attention (csrc/flash_attention.cu), on
the feature-extraction path, which no cell drives yet: its launches are
named and its least work is not counted."""

NAMES = ("flash_fwd_kernel",)


def least_s(ctx) -> float:
    return 0.0
