"""Fused temporal-tower layer: the CUDA kernels and their plain version.

`fused_temporal_layer` replaces the Pallas TPU kernels of
mgsv_tpu/ops/pallas/fused_temporal_layer.py: `_fwd_pallas` (the forward,
with its three dropout sites) and, through its autograd Function,
`_bwd_pallas` (the backward by recompute).  `FusedTemporalTransformer`
(models/temporal.py, `Config.model.fused_temporal`) runs every layer of
both towers through it: training at the configuration's rate (0.8),
evaluation at rate 0.  The layer, with the residual taken after each norm:

    y = LN1(x);  u = y + MHA(y, y, y, key_mask);  z = LN2(u)
    out = z + drop_H+1(fc2(drop_H(gelu(fc1(z)))))

On a CUDA tensor it launches csrc/fused_temporal_layer.cu and, for the
gradient, csrc/fused_temporal_layer_bwd.cu (built at first use, see
runtime/kernels.py), or raises; on a CPU tensor it runs
`fused_temporal_layer_reference`, the layer's own plain PyTorch forward
with the same Philox masks (ops/philox.py::temporal_masks), and autograd
differentiates that.  The kernel sources say what bounds them on the card
and how they split the work.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import TYPE_CHECKING

import torch

from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.runtime import kernels

if TYPE_CHECKING:
    from mgsv_tpu_torch.models.temporal import TemporalLayer

# The shapes the kernels take; csrc/temporal_layer.cuh guards the same.
HEAD_DIM = 32      # the attention maps one lane to one head channel
DIM = 256          # the LayerNorm launches take rows of D = 256, 8 values a lane
# The longer of the towers' sinusoidal tables (audio_pe_len 300; video 250):
# no tower input is longer.  The attention's shared memory would allow up
# to 500 (forward, 464 L bytes) and 382 (backward, 608 L bytes).
MAX_L = 300
MAX_B = 65535      # grid y of the attention launches

# layer -> (device, weight pointers) of the last weights that passed the check
_checked_weights: "weakref.WeakKeyDictionary[TemporalLayer, tuple]" = (
    weakref.WeakKeyDictionary())


def fused_temporal_layer_reference(x: torch.Tensor, mask: torch.Tensor,
                                   layer: TemporalLayer, rate: float = 0.0,
                                   seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the layer's forward with the
    kernels' Philox masks (the JAX package's temporal_layer_fwd_with_masks);
    differentiable, so its autograd gradient is the plain version of the
    backward kernel."""
    masks = None
    if rate > 0.0:
        b, L, d = x.shape
        masks = philox.temporal_masks(seed, b, L, d, layer[3][0].out_features,
                                      layer[1].heads, rate, device=x.device)
    return layer(x, mask, masks=masks)


def _layer_tensors(layer: TemporalLayer):
    norm1, attn, norm2, ff = layer
    return (attn.in_proj_weight, attn.in_proj_bias, attn.out_proj.weight, attn.out_proj.bias,
            norm1.weight, norm1.bias, ff[0].weight, ff[0].bias, ff[3].weight, ff[3].bias,
            norm2.weight, norm2.bias)


def _check_tensors(tensors, device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError("fused_temporal_layer: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise ValueError("fused_temporal_layer: the kernels take float32 only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_temporal_layer: tensors must be contiguous and "
                             "16-byte aligned")


def _check_inputs(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer) -> None:
    _check_tensors((x, mask), x.device)
    if x.dim() != 3 or mask.shape != x.shape[:2]:
        raise ValueError(f"fused_temporal_layer: x {tuple(x.shape)}, mask {tuple(mask.shape)}")
    b, L, d = x.shape
    if not (1 <= b <= MAX_B and 1 <= L <= MAX_L and d == DIM
            and layer[1].heads * HEAD_DIM == DIM):
        raise ValueError(
            f"fused_temporal_layer: unsupported shape B={b} L={L} D={d} "
            f"H={layer[1].heads} (needs D={DIM}, head dim {HEAD_DIM}, "
            f"1 <= L <= {MAX_L}, B <= {MAX_B})")


def _check_weights(weights, device: torch.device) -> None:
    _check_tensors(weights, device)
    f = weights[6].shape[0]                          # fc1.weight [F, D]
    want = [(3 * DIM, DIM), (3 * DIM,), (DIM, DIM), (DIM,), (DIM,), (DIM,),
            (f, DIM), (f,), (DIM, f), (DIM,), (DIM,), (DIM,)]
    if [tuple(w.shape) for w in weights] != want or f < DIM or f % DIM:
        raise ValueError(f"fused_temporal_layer: unsupported layer widths "
                         f"{[tuple(w.shape) for w in weights]} (needs D={DIM}, "
                         f"FFN width a multiple of {DIM})")


def check_supported(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer) -> None:
    """Raise ValueError for inputs the CUDA kernels do not take."""
    _check_inputs(x, mask, layer)
    _check_weights(_layer_tensors(layer), x.device)


def _weights(layer: TemporalLayer, device: torch.device) -> tuple:
    """The layer's tensors in the kernels' order; checked again only after
    one of them moved (to another device, dtype or storage)."""
    weights = _layer_tensors(layer)
    key = (device,) + tuple(w.data_ptr() for w in weights)
    if _checked_weights.get(layer) != key:
        _check_weights(weights, device)
        _checked_weights[layer] = key
    return weights


@functools.cache
def _launcher(device_index: int):
    """The forward's C entry points (workspace size, launch), with its
    kernels' shared-memory limits set once on this device (call with the
    device current)."""
    lib = kernels.load_initialized("fused_temporal_layer", device_index)
    size = lib.mgsv_fused_temporal_layer_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.mgsv_fused_temporal_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return size, fn


@functools.cache
def _bwd_launcher(device_index: int):
    """The backward's C entry points (workspace size, launch)."""
    lib = kernels.load_initialized("fused_temporal_layer_bwd", device_index)
    size = lib.mgsv_fused_temporal_layer_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.mgsv_fused_temporal_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 29 + [ctypes.c_int] * 5
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return size, fn


def _forward_kernel(x, mask, layer, weights, rate, seed) -> torch.Tensor:
    (b, L, d), f = x.shape, weights[6].shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        size, launch = _launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f)))
        args = [t.data_ptr() for t in (x, mask) + tuple(weights) + (ws, out)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*args, b, L, d, layer[1].heads, f, *philox.kernel_args(rate, seed), stream)
    if err != 0:
        raise RuntimeError(f"fused_temporal_layer: CUDA error {err} at launch")
    fused_temporal_layer.launches += 1
    return out


def fused_temporal_layer_bwd(x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                             layer: TemporalLayer, rate: float = 0.0, seed: int = 0):
    """Backward of the layer by recompute: (dx, gradients of the 12 tensors
    of `_layer_tensors(layer)`, in that order).  CUDA tensors only: the
    plain version of this kernel is autograd through
    `fused_temporal_layer_reference`."""
    if x.device.type != "cuda":
        raise ValueError("fused_temporal_layer_bwd: the kernel takes CUDA tensors; "
                         "on the CPU differentiate fused_temporal_layer_reference")
    _check_inputs(x, mask, layer)
    _check_tensors((g,), x.device)
    if g.shape != x.shape:
        raise ValueError(f"fused_temporal_layer_bwd: g {tuple(g.shape)} vs x {tuple(x.shape)}")
    weights = _weights(layer, x.device)
    (b, L, d), f = x.shape, weights[6].shape[0]
    grads = [torch.empty_like(w) for w in weights]
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        size, launch = _bwd_launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f)))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [t.data_ptr() for t in (x, mask, g) + tuple(weights) + (dx,) + tuple(grads)
                + (ws,)]
        err = launch(*args, b, L, d, layer[1].heads, f, *philox.kernel_args(rate, seed), stream)
    if err != 0:
        raise RuntimeError(f"fused_temporal_layer_bwd: CUDA error {err} at launch")
    fused_temporal_layer_bwd.launches += 1
    return dx, grads


fused_temporal_layer_bwd.launches = 0


class _TemporalLayerFn(torch.autograd.Function):
    """Forward kernel, backward kernel; saves only the inputs, the weights
    and the seed (the backward recomputes the rest: no masks, no [L, L]
    weights are stored)."""

    @staticmethod
    def forward(ctx, x, mask, layer, rate, seed, *weights):
        ctx.layer, ctx.rate, ctx.seed = layer, rate, seed
        ctx.save_for_backward(x, mask)
        return _forward_kernel(x, mask, layer, weights, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x, mask = ctx.saved_tensors
        dx, grads = fused_temporal_layer_bwd(x, mask, g.contiguous(), ctx.layer, ctx.rate,
                                             ctx.seed)
        return (dx, None, None, None, None, *grads)


def fused_temporal_layer(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer,
                         rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """The temporal layer with dropout `rate` drawn from the Philox stream
    `seed` (ops/philox.py).  x [B, L, D] float32, mask [B, L] float32
    (1 = valid) -> [B, L, D]; differentiable.

    A CPU tensor runs the plain version; a CUDA tensor launches the forward
    kernel (counted in `fused_temporal_layer.launches`), and its gradient
    the backward kernel (`fused_temporal_layer_bwd.launches`), or raises."""
    if x.device.type == "cpu":
        return fused_temporal_layer_reference(x, mask, layer, rate, seed)
    _check_inputs(x, mask, layer)
    weights = _weights(layer, x.device)
    return _TemporalLayerFn.apply(x, mask, layer, rate, seed, *weights)


fused_temporal_layer.launches = 0
