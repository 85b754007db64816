"""Fused post-norm DETR encoder layer: the CUDA kernel and its plain version.

`fused_encoder_layer` replaces the Pallas TPU kernels
mgsv_tpu/ops/pallas/fused_encoder_layer.py::fused_encoder_layer (forward,
with its four dropout sites) and, through its autograd Function,
mgsv_tpu/ops/pallas/fused_encoder_layer_vjp.py::_bwd_pallas (the backward
by recompute): the serving path runs it at rate 0, training at the
configuration's rate.  On a CUDA tensor it launches
csrc/fused_encoder_layer.cu and, for the gradient,
csrc/fused_encoder_layer_bwd.cu (built at first use, see
runtime/kernels.py), or raises; on a CPU tensor it runs
`fused_encoder_layer_reference`, the layer's own plain PyTorch forward with
the same Philox masks, and autograd differentiates that.  The kernel
sources say what bounds them on the card and how they split the work.

`precision` follows the JAX kernels' argument: "f32" (float32 products,
3xTF32 on the card) or "bf16" (every product, forward and backward, with
bf16 operands and float32 sums; inputs, outputs, LayerNorm, softmax and
the dropout masks stay float32).  The model takes "bf16" under a bf16
compute dtype, as JAX's FusedDetrEncoderLayer does.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.runtime import kernels

if TYPE_CHECKING:
    from mgsv_tpu_torch.models.detr import DetrEncoderLayer

# The shapes the kernel takes; csrc/fused_encoder_layer.cu guards the same.
HEAD_DIM = 32      # the kernel maps one lane to one head channel
DIM = 256          # the LayerNorm launches take a row of D = 256, one warp each
MAX_L = 256        # the attention block's shared memory is sized for this L
MAX_B = 65535      # grid y of the attention launch
PRECISIONS = ("f32", "bf16")
BIG_NEG = -1e9     # a masked key's score, as in the JAX kernels

# layer -> (device, weight pointers) of the last weights that passed the check
_checked_weights: "weakref.WeakKeyDictionary[DetrEncoderLayer, tuple]" = (
    weakref.WeakKeyDictionary())


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bf16, in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16Matmul(torch.autograd.Function):
    """(a @ b) * scale with both operands rounded to bf16 and the sums in
    a's dtype (TF32 off): JAX's dot of bf16 operands with
    preferred_element_type=float32.  The backward's products round their
    operands the same way and scale after the product, as the VJP of JAX's
    precision="bf16" kernel casts each operand of each of its dots."""

    @staticmethod
    def forward(ctx, a, b, scale):
        ctx.save_for_backward(a, b)
        ctx.scale = scale
        return (_bf16(a) @ _bf16(b)) * scale

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _bf16(g)
        da = (g @ _bf16(b).mT) * ctx.scale
        db = (_bf16(a).mT @ g) * ctx.scale
        return da.sum_to_size(a.shape), db.sum_to_size(b.shape), None


def bf16_matmul(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    return _Bf16Matmul.apply(a, b, scale)


def _bf16_layer(x, mask, pos, layer: DetrEncoderLayer, masks) -> torch.Tensor:
    """The layer at precision "bf16": the module's forward with each
    product taken by `bf16_matmul` (JAX's fused_encoder_layer with
    mxu_dtype=bfloat16, fused_encoder_layer.py:_fused_layer_kernel)."""
    sa = layer.self_attn
    b, L, d = x.shape
    dh = d // sa.heads
    wq, wk, wv = sa.in_proj_weight.chunk(3, dim=0)
    bq, bk, bv = sa.in_proj_bias.chunk(3, dim=0)
    split = lambda t: t.reshape(b, L, sa.heads, dh).transpose(1, 2)
    a = x + pos
    q = split(bf16_matmul(a, wq.T) + bq)
    k = split(bf16_matmul(a, wk.T) + bk)
    v = split(bf16_matmul(x, wv.T) + bv)
    s = bf16_matmul(q, k.mT, 1.0 / math.sqrt(dh))                  # [B, H, L, L]
    s = torch.where(mask[:, None, None, :] != 0, s, torch.full_like(s, BIG_NEG))
    p = torch.softmax(s, dim=-1)
    if masks is not None:
        p = p * masks["attn"]
    ctx = bf16_matmul(p, v).transpose(1, 2).reshape(b, L, d)
    o = bf16_matmul(ctx, sa.out_proj.weight.T) + sa.out_proj.bias
    if masks is not None:
        o = o * masks["attn_out"]
    y1 = layer.norm1(x + o)
    h1 = F.relu(bf16_matmul(y1, layer.linear1.weight.T) + layer.linear1.bias)
    if masks is not None:
        h1 = h1 * masks["ffn1"]
    h2 = bf16_matmul(h1, layer.linear2.weight.T) + layer.linear2.bias
    if masks is not None:
        h2 = h2 * masks["ffn2"]
    return layer.norm2(y1 + h2)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"fused_encoder_layer: precision {precision!r}, "
                         f"not one of {PRECISIONS}")


def fused_encoder_layer_reference(x: torch.Tensor, mask: torch.Tensor,
                                  pos: torch.Tensor, layer: DetrEncoderLayer,
                                  rate: float = 0.0, seed: int = 0,
                                  precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of the kernel: the module's forward with the
    kernel's Philox masks (the JAX package's layer_fwd_with_masks), at
    "bf16" with every product's operands rounded to bf16 (`_bf16_layer`);
    differentiable, so its autograd gradient is the plain version of the
    backward kernel.  Runs outside any autocast: the precision says where
    it rounds."""
    _check_precision(precision)
    masks = None
    if rate > 0.0:
        b, L, d = x.shape
        masks = philox.encoder_masks(seed, b, L, d, layer.linear1.out_features,
                                     layer.self_attn.heads, rate, device=x.device)
    with torch.autocast(x.device.type, enabled=False):
        if precision == "bf16":
            return _bf16_layer(x, mask, pos, layer, masks)
        return layer(x, mask, pos, masks)


def _layer_tensors(layer: DetrEncoderLayer):
    sa = layer.self_attn
    return (sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias,
            layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias,
            layer.norm2.weight, layer.norm2.bias)


def _check_tensors(tensors, device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError("fused_encoder_layer: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise ValueError("fused_encoder_layer: the kernel takes float32 only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_encoder_layer: tensors must be contiguous and "
                             "16-byte aligned")


def _check_inputs(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                  layer: DetrEncoderLayer) -> None:
    _check_tensors((x, mask, pos), x.device)
    if x.dim() != 3 or pos.shape != x.shape or mask.shape != x.shape[:2]:
        raise ValueError(f"fused_encoder_layer: x {tuple(x.shape)}, pos "
                         f"{tuple(pos.shape)}, mask {tuple(mask.shape)}")
    b, L, d = x.shape
    if not (1 <= b <= MAX_B and 1 <= L <= MAX_L and d == DIM
            and layer.self_attn.heads * HEAD_DIM == DIM):
        raise ValueError(
            f"fused_encoder_layer: unsupported shape B={b} L={L} D={d} "
            f"H={layer.self_attn.heads} (needs D={DIM}, head dim {HEAD_DIM}, "
            f"1 <= L <= {MAX_L}, B <= {MAX_B})")


def _check_weights(weights, device: torch.device) -> None:
    _check_tensors(weights, device)
    f = weights[6].shape[0]                          # linear1.weight [F, D]
    want = [(3 * DIM, DIM), (3 * DIM,), (DIM, DIM), (DIM,), (DIM,), (DIM,),
            (f, DIM), (f,), (DIM, f), (DIM,), (DIM,), (DIM,)]
    if [tuple(w.shape) for w in weights] != want or f < DIM or f % DIM:
        raise ValueError(f"fused_encoder_layer: unsupported layer widths "
                         f"{[tuple(w.shape) for w in weights]} (needs D={DIM}, "
                         f"FFN width a multiple of {DIM})")


def check_supported(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                    layer: DetrEncoderLayer) -> None:
    """Raise ValueError for inputs the CUDA kernel does not take."""
    _check_inputs(x, mask, pos, layer)
    _check_weights(_layer_tensors(layer), x.device)


def _weights(layer: DetrEncoderLayer, device: torch.device) -> tuple:
    """The layer's tensors in the kernel's order; checked again only after
    one of them moved (to another device, dtype or storage)."""
    weights = _layer_tensors(layer)
    key = (device,) + tuple(w.data_ptr() for w in weights)
    if _checked_weights.get(layer) != key:
        _check_weights(weights, device)
        _checked_weights[layer] = key
    return weights


@functools.cache
def _launcher(device_index: int):
    """The forward's C entry points (workspace size, launch), with the
    kernels' shared-memory limits set once on this device (call with the
    device current)."""
    lib = kernels.load_initialized("fused_encoder_layer", device_index)
    size = lib.mgsv_fused_encoder_layer_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.mgsv_fused_encoder_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return size, fn


@functools.cache
def _bwd_launcher(device_index: int):
    """The backward's C entry points (workspace size, launch)."""
    lib = kernels.load_initialized("fused_encoder_layer_bwd", device_index)
    size = lib.mgsv_fused_encoder_layer_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    fn = lib.mgsv_fused_encoder_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 31 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return size, fn


def _forward_kernel(x, mask, pos, layer, weights, rate, seed, precision) -> torch.Tensor:
    (b, L, d), f = x.shape, weights[6].shape[0]
    out = torch.empty_like(x)
    seed = philox.device_seed(seed, rate, x.device)
    with torch.cuda.device(x.device):
        size, launch = _launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f)))
        args = [t.data_ptr() for t in (x, pos, mask) + tuple(weights) + (ws, out)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*args, b, L, d, layer.self_attn.heads, f,
                     *philox.kernel_args(rate, seed), int(precision == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer: CUDA error {err} at launch")
    fused_encoder_layer.launches += 1
    return out


def fused_encoder_layer_bwd(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                            g: torch.Tensor, layer: DetrEncoderLayer,
                            rate: float = 0.0, seed: int = 0, precision: str = "f32"):
    """Backward of the layer by recompute: (dx, dpos, gradients of the 12
    tensors of `_layer_tensors(layer)`, in that order).  CUDA tensors only:
    the plain version of this kernel is autograd through
    `fused_encoder_layer_reference`."""
    _check_precision(precision)
    if x.device.type != "cuda":
        raise ValueError("fused_encoder_layer_bwd: the kernel takes CUDA tensors; "
                         "on the CPU differentiate fused_encoder_layer_reference")
    _check_inputs(x, mask, pos, layer)
    _check_tensors((g,), x.device)
    if g.shape != x.shape:
        raise ValueError(f"fused_encoder_layer_bwd: g {tuple(g.shape)} vs x {tuple(x.shape)}")
    weights = _weights(layer, x.device)
    (b, L, d), f = x.shape, weights[6].shape[0]
    grads = [torch.empty_like(w) for w in weights]
    dx, dpos = torch.empty_like(x), torch.empty_like(x)
    seed = philox.device_seed(seed, rate, x.device)
    with torch.cuda.device(x.device):
        size, launch = _bwd_launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f)))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [t.data_ptr() for t in (x, pos, mask, g) + tuple(weights)
                + (dx, dpos) + tuple(grads) + (ws,)]
        err = launch(*args, b, L, d, layer.self_attn.heads, f,
                     *philox.kernel_args(rate, seed), int(precision == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer_bwd: CUDA error {err} at launch")
    fused_encoder_layer_bwd.launches += 1
    return dx, dpos, grads


fused_encoder_layer_bwd.launches = 0


class _EncoderLayerFn(torch.autograd.Function):
    """Forward kernel #1, backward kernel #2; saves only the inputs, the
    weights and the seed (the backward recomputes the rest)."""

    @staticmethod
    def forward(ctx, x, mask, pos, layer, rate, seed, precision, *weights):
        ctx.layer, ctx.rate, ctx.seed, ctx.precision = layer, rate, seed, precision
        ctx.save_for_backward(x, mask, pos)
        return _forward_kernel(x, mask, pos, layer, weights, rate, seed, precision)

    @staticmethod
    def backward(ctx, g):
        x, mask, pos = ctx.saved_tensors
        dx, dpos, grads = fused_encoder_layer_bwd(x, mask, pos, g.contiguous(), ctx.layer,
                                                  ctx.rate, ctx.seed, ctx.precision)
        return (dx, None, dpos, None, None, None, None, *grads)


def fused_encoder_layer(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                        layer: DetrEncoderLayer, rate: float = 0.0,
                        seed: int = 0, precision: str = "f32") -> torch.Tensor:
    """Post-norm DetrEncoderLayer forward with dropout `rate` drawn from the
    Philox stream `seed` (ops/philox.py), at `precision` ("f32" | "bf16").
    x, pos [B, L, D] float32, mask [B, L] float32 (1 = valid) -> [B, L, D];
    differentiable.

    A CPU tensor runs the plain version; a CUDA tensor launches the forward
    kernel (counted in `fused_encoder_layer.launches`), and its gradient
    the backward kernel (`fused_encoder_layer_bwd.launches`), or raises."""
    _check_precision(precision)
    if x.device.type == "cpu":
        return fused_encoder_layer_reference(x, mask, pos, layer, rate, seed, precision)
    _check_inputs(x, mask, pos, layer)
    weights = _weights(layer, x.device)
    return _EncoderLayerFn.apply(x, mask, pos, layer, rate, seed, precision, *weights)


fused_encoder_layer.launches = 0
