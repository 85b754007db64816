"""Non-causal attention with an optional key mask: the CUDA kernel and its
plain version.

`flash_attention` replaces the Pallas TPU kernel
mgsv_tpu/ops/pallas/flash_attention.py::flash_attention, and
`make_attention_fn` its drop-in for the frozen towers' ViT blocks
(models/vit_common.py): keys shorter than `min_seq_len` take
`default_attention`, longer ones the kernel, so the AST's 1,214 tokens run
on it and CLIP's 50 do not.  Per (batch, head)

    o = softmax_keys(q k^T scale + bias) v,   bias = 0 on valid keys,
                                              -1e30 where key_mask == 0

and a row whose every key is masked gives 0.  On a CUDA tensor the wrapper
launches csrc/flash_attention.cu (built at first use, see
runtime/kernels.py) or raises; on a CPU tensor it runs
`flash_attention_reference`, the plain PyTorch version.  The kernel source
says what bounds it on the card and how it splits the work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mgsv_tpu_torch.runtime import kernels

NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIM = 64      # the kernel's fragments span one head of 64 channels
MIN_SEQ_LEN = 512  # make_attention_fn: shorter keys take the plain einsum path
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float,
                              key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in float32: masked keys' logits
    set to -1e30, a softmax over keys, rows with no valid key set to 0; the
    output in q's dtype.  q [B, H, Lq, Dh], k and v [B, H, Lk, Dh],
    key_mask [B, Lk] (nonzero = valid)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        logits.masked_fill_(~valid, NEG_INF)
    out = torch.matmul(torch.softmax(logits, dim=-1), v.float())
    if key_mask is not None:
        out.masked_fill_(~valid.any(dim=-1, keepdim=True), 0.0)
    return out.to(q.dtype)


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in place (head dimension
    contiguous, every row start 16-byte aligned), else a contiguous copy."""
    align = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % align == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_mask: Optional[torch.Tensor]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (want [B, H, L, Dh])")
    b, h, lq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d or lq < 1 or k.shape[2] < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch, heads or head dim")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d}; the kernel takes {HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
                         "kernel takes float32 or bfloat16, the same for q, k and v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if key_mask is not None and (key_mask.shape != (b, k.shape[2])
                                 or key_mask.device != q.device):
        raise ValueError(f"flash_attention: key_mask {tuple(key_mask.shape)} on "
                         f"{key_mask.device}, want [{b}, {k.shape[2]}] on {q.device}")


@functools.cache
def _launcher(device_index: int):
    """The kernel's C entry point, with its shared-memory limits set once on
    this device (call with the device current)."""
    fn = kernels.load_initialized("flash_attention", device_index).mgsv_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over [B, H, L, Dh] tensors (float32 or bfloat16, Dh = 64;
    Lq and Lk need not be equal or multiples of a tile) with an optional
    key_mask [B, Lk] (nonzero = valid) -> [B, H, Lq, Dh] in q's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in `flash_attention.launches`, one per call) or raises.  The
    result is a [B, H, Lq, Dh] view of a [B, Lq, H, Dh] tensor, so merging
    the heads back into [B, Lq, H Dh] costs no copy."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, key_mask)
    _check(q, k, v, key_mask)
    q, k, v = (_kernel_rows(t) for t in (q, k, v))
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    mask = None if key_mask is None else key_mask.to(torch.float32).contiguous()
    with torch.cuda.device(q.device):
        launch = _launcher(q.device.index)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if mask is None else mask.data_ptr(), out.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     b, h, lq, lk, d, float(scale) * LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def make_attention_fn(min_seq_len: int = MIN_SEQ_LEN):
    """An `attention_fn` for the ViT blocks (models/vit_common.py): keys
    shorter than min_seq_len take `default_attention`, longer ones
    `flash_attention` (no key mask)."""
    from mgsv_tpu_torch.models.vit_common import default_attention

    def attention_fn(q, k, v, scale):
        if k.shape[2] < min_seq_len:
            return default_attention(q, k, v, scale)
        return flash_attention(q, k, v, float(scale))

    return attention_fn
