"""Precisions for the reference: float32 with TF32 off (the reference), and
the control's lower precisions.

`lowered("fp8")` rounds both operands of every matrix product (linear,
matmul, bmm, einsum) to float8 e4m3 with one scale per tensor, its absolute
maximum mapped to 448, as fp8 training and inference scale them, and takes
the product in float32.  The gradient passes the rounding unchanged
(straight through), so a training step runs in it too.  `lowered("tf32")`
lets cuBLAS take float32 products as TF32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {F.linear, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.bmm, torch.einsum}


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, as float32; the
    gradient passes straight through."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    r = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (r - x.detach())


class _Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            lo = lambda a: round_fp8(a) if isinstance(a, torch.Tensor) and a.is_floating_point() \
                and a.dim() >= 2 else a
            if func is torch.einsum:
                args = (args[0], *[lo(a) for a in args[1:]])
            elif func is F.linear:
                args = (lo(args[0]), lo(args[1]), *args[2:])
            else:
                args = tuple(lo(a) for a in args)
        return func(*args, **kwargs)


def strict_fp32() -> None:
    """Float32 products in float32 (no TF32), for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def lowered(precision: str):
    """Run the reference at `precision`: "fp32" (itself), "tf32" or "fp8"."""
    if precision == "fp32":
        strict_fp32()
        yield
    elif precision == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            strict_fp32()
    elif precision == "fp8":
        strict_fp32()
        with _Fp8Products():
            yield
    else:
        raise ValueError(f"unknown precision {precision!r}")
