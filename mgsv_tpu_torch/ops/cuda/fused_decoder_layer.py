"""Fused post-norm DETR decoder layer: the CUDA kernels and their plain version.

`fused_decoder_layer` replaces the Pallas TPU kernels of
mgsv_tpu/ops/pallas/fused_decoder_layer.py: `_fwd_call` (the forward) and,
through its autograd Function, `_train_bwd` (the backward by recompute),
the pair that JAX's `fused_decoder_layer_train` and `FusedDetrDecoderLayer`
run.  It takes an existing `DetrDecoderLayer`'s parameters (JAX's
checkpoint-compatible tree, through interop/state_dict.py) and computes, in
float32 and without dropout:

    t1  = LN1(tgt + SA(tgt + qpos, tgt + qpos, tgt))   (without self-attention t1 = tgt)
    t2  = LN2(t1 + CA(t1 + qpos, memory + pos, memory, key mask))
    out = LN3(t2 + W2 relu(W1 t2 + b1) + b2)

`DetrDecoder` runs every layer through it with `fused_decoder=True`
(models/detr.py, the call argument threaded from MaDe.forward, the train
and eval steps and `evaluate`).  On a CUDA tensor it launches
csrc/fused_decoder_layer.cu and, for the gradient,
csrc/fused_decoder_layer_bwd.cu (built at first use, see runtime/kernels.py),
or raises; on a CPU tensor it runs `fused_decoder_layer_reference`, the
layer's own plain forward, and autograd differentiates that.  When the
layer needs a gradient, the forward keeps the memory's k|v ([B, L, 2D],
the cross-attention's k and v projections, 159 MB at B=512 and L=152) for
the backward, which then does not project the memory again.  The kernel
sources say what bounds them on the card and how they split the work.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import TYPE_CHECKING, Optional

import torch

from mgsv_tpu_torch.runtime import kernels

if TYPE_CHECKING:
    from mgsv_tpu_torch.models.detr import DetrDecoderLayer

# The shapes the kernels take; csrc/decoder_layer_kernels.cuh guards the same.
HEAD_DIM = 32      # the attention maps one lane to one head channel
DIM = 256          # the LayerNorm launches take rows of D = 256, 8 values a lane
MAX_L = 256        # memory rows and queries: the attention's shared memory
MAX_B = 65535      # grid y of the attention launches

# layer -> (device, weight pointers) of the last weights that passed the check
_checked_weights: "weakref.WeakKeyDictionary[DetrDecoderLayer, tuple]" = (
    weakref.WeakKeyDictionary())


def _check_self_attn(layer: DetrDecoderLayer, self_attn: Optional[bool]) -> None:
    has = layer.self_attn is not None
    if self_attn is not None and self_attn != has:
        raise ValueError(f"fused_decoder_layer: self_attn={self_attn}, but the layer "
                         f"{'has' if has else 'has no'} self-attention parameters")


def fused_decoder_layer_reference(tgt: torch.Tensor, memory: torch.Tensor,
                                  mask: torch.Tensor, pos: torch.Tensor,
                                  query_pos: torch.Tensor, layer: DetrDecoderLayer,
                                  self_attn: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the layer's own forward without
    dropout, outside any autocast; differentiable, so its autograd gradient
    is the plain version of the backward kernel."""
    _check_self_attn(layer, self_attn)
    with torch.autocast(tgt.device.type, enabled=False):
        return layer(tgt, memory, mask, pos, query_pos)


def _layer_tensors(layer: DetrDecoderLayer):
    """The layer's tensors in the kernels' order: the self-attention's six
    (when it has one), then the cross-attention, LN2, the FFN and LN3."""
    out = []
    if layer.self_attn is not None:
        sa = layer.self_attn
        out += [sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
                layer.norm1.weight, layer.norm1.bias]
    ca = layer.multihead_attn
    out += [ca.in_proj_weight, ca.in_proj_bias, ca.out_proj.weight, ca.out_proj.bias,
            layer.norm2.weight, layer.norm2.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm3.weight, layer.norm3.bias]
    return tuple(out)


def _check_tensors(tensors, device: torch.device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError("fused_decoder_layer: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise ValueError("fused_decoder_layer: the kernels take float32 only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_decoder_layer: tensors must be contiguous and "
                             "16-byte aligned")


def _check_inputs(tgt, memory, mask, pos, query_pos, layer) -> None:
    _check_tensors((tgt, memory, mask, pos, query_pos), tgt.device)
    if (tgt.dim() != 3 or query_pos.shape != tgt.shape or memory.dim() != 3
            or pos.shape != memory.shape or mask.shape != memory.shape[:2]
            or memory.shape[0] != tgt.shape[0] or memory.shape[2] != tgt.shape[2]):
        raise ValueError(f"fused_decoder_layer: tgt {tuple(tgt.shape)}, query_pos "
                         f"{tuple(query_pos.shape)}, memory {tuple(memory.shape)}, pos "
                         f"{tuple(pos.shape)}, mask {tuple(mask.shape)}")
    (b, q, d), length = tgt.shape, memory.shape[1]
    if not (1 <= b <= MAX_B and 1 <= q <= MAX_L and 1 <= length <= MAX_L and d == DIM
            and layer.multihead_attn.heads * HEAD_DIM == DIM):
        raise ValueError(
            f"fused_decoder_layer: unsupported shape B={b} Q={q} L={length} D={d} "
            f"H={layer.multihead_attn.heads} (needs D={DIM}, head dim {HEAD_DIM}, "
            f"1 <= Q, L <= {MAX_L}, B <= {MAX_B})")


def _check_weights(weights, device: torch.device) -> None:
    _check_tensors(weights, device)
    f = weights[-6].shape[0]                          # linear1.weight [F, D]
    attn = [(3 * DIM, DIM), (3 * DIM,), (DIM, DIM), (DIM,), (DIM,), (DIM,)]
    want = (attn if len(weights) == 18 else []) + attn + [
        (f, DIM), (f,), (DIM, f), (DIM,), (DIM,), (DIM,)]
    if [tuple(w.shape) for w in weights] != want or f < DIM or f % DIM:
        raise ValueError(f"fused_decoder_layer: unsupported layer widths "
                         f"{[tuple(w.shape) for w in weights]} (needs D={DIM}, "
                         f"FFN width a multiple of {DIM})")


def check_supported(tgt, memory, mask, pos, query_pos, layer: DetrDecoderLayer) -> None:
    """Raise ValueError for inputs the CUDA kernels do not take."""
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    _check_weights(_layer_tensors(layer), tgt.device)


def _weights(layer: DetrDecoderLayer, device: torch.device) -> tuple:
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
    """The forward's C entry points (workspace size, launch), with the
    kernels' shared-memory limits set once on this device."""
    lib = kernels.load_initialized("fused_decoder_layer", device_index)
    size = lib.mgsv_fused_decoder_layer_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 4
    fn = lib.mgsv_fused_decoder_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return size, fn


@functools.cache
def _bwd_launcher(device_index: int):
    """The backward's C entry points (workspace size, launch)."""
    lib = kernels.load_initialized("fused_decoder_layer_bwd", device_index)
    size = lib.mgsv_fused_decoder_layer_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 5
    fn = lib.mgsv_fused_decoder_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 48 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return size, fn


def _slots(tensors, self_attn: bool) -> list:
    """Pointers in the C functions' 18 weight slots: 0 for the
    self-attention's six without self-attention."""
    ptrs = [t.data_ptr() for t in tensors]
    return ptrs if self_attn else [0] * 6 + ptrs


def _forward_kernel(tgt, memory, mask, pos, query_pos, layer, weights, self_attn):
    """(out, the memory's k|v [B, L, 2D])."""
    (b, q, d), length, f = tgt.shape, memory.shape[1], weights[-6].shape[0]
    out = torch.empty_like(tgt)
    kv = memory.new_empty(b, length, 2 * d)
    with torch.cuda.device(tgt.device):
        size, launch = _launcher(tgt.device.index)
        ws = tgt.new_empty(int(size(b, q, length, f)))
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        args = ([t.data_ptr() for t in (tgt, memory, mask, pos, query_pos)]
                + _slots(weights, self_attn) + [out.data_ptr(), kv.data_ptr(), ws.data_ptr()])
        err = launch(*args, b, q, length, d, layer.multihead_attn.heads, f, int(self_attn),
                     stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder_layer: CUDA error {err} at launch")
    fused_decoder_layer.launches += 1
    return out, kv


def fused_decoder_layer_fwd(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                            pos: torch.Tensor, query_pos: torch.Tensor,
                            layer: DetrDecoderLayer):
    """The forward kernel alone, outside autograd: (out, the memory's k|v
    [B, L, 2D] that `fused_decoder_layer_bwd` may take).  CUDA tensors
    only, contiguous (`fused_decoder_layer` is the layer's entry point)."""
    if tgt.device.type != "cuda":
        raise ValueError("fused_decoder_layer_fwd: the kernel takes CUDA tensors; "
                         "on the CPU run fused_decoder_layer_reference")
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    return _forward_kernel(tgt, memory, mask, pos, query_pos, layer,
                           _weights(layer, tgt.device), layer.self_attn is not None)


def _check_kv(kv: torch.Tensor, memory: torch.Tensor) -> None:
    """A k|v the backward takes: the forward's, [B, L, 2D] float32 on
    memory's device, contiguous and 16-byte aligned."""
    b, length, d = memory.shape
    if (kv.dtype != torch.float32 or tuple(kv.shape) != (b, length, 2 * d)
            or kv.device != memory.device or not kv.is_contiguous() or kv.data_ptr() % 16):
        raise ValueError(f"fused_decoder_layer_bwd: kv {tuple(kv.shape)} {kv.dtype} on "
                         f"{kv.device} is not the forward's k|v of memory "
                         f"{tuple(memory.shape)}: needs [{b}, {length}, {2 * d}] float32 on "
                         f"{memory.device}, contiguous")


def fused_decoder_layer_bwd(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                            pos: torch.Tensor, query_pos: torch.Tensor, g: torch.Tensor,
                            layer: DetrDecoderLayer, kv: Optional[torch.Tensor] = None):
    """Backward of the layer by recompute: (dtgt, dmemory, dpos, dquery_pos,
    gradients of the tensors of `_layer_tensors(layer)`, in that order).
    Given `kv`, the forward's k|v of the same inputs (`fused_decoder_layer_fwd`),
    the recompute takes it instead of projecting the memory again; the
    result is the same to the bit.  CUDA tensors only: the plain version of
    this kernel is autograd through `fused_decoder_layer_reference`."""
    if kv is not None:
        _check_kv(kv, memory)
    if tgt.device.type != "cuda":
        raise ValueError("fused_decoder_layer_bwd: the kernel takes CUDA tensors; "
                         "on the CPU differentiate fused_decoder_layer_reference")
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    _check_tensors((g,), tgt.device)
    if g.shape != tgt.shape:
        raise ValueError(f"fused_decoder_layer_bwd: g {tuple(g.shape)} vs tgt "
                         f"{tuple(tgt.shape)}")
    weights = _weights(layer, tgt.device)
    self_attn = layer.self_attn is not None
    (b, q, d), length, f = tgt.shape, memory.shape[1], weights[-6].shape[0]
    grads = [torch.empty_like(w) for w in weights]
    dtgt, dqpos = torch.empty_like(tgt), torch.empty_like(tgt)
    dmem, dpos = torch.empty_like(memory), torch.empty_like(memory)
    with torch.cuda.device(tgt.device):
        size, launch = _bwd_launcher(tgt.device.index)
        ws = tgt.new_empty(int(size(b, q, length, f, int(kv is not None))))
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        args = ([t.data_ptr() for t in (tgt, memory, mask, pos, query_pos, g)]
                + _slots(weights, self_attn)
                + [t.data_ptr() for t in (dtgt, dmem, dpos, dqpos)]
                + _slots(grads, self_attn)
                + [0 if kv is None else kv.data_ptr(), ws.data_ptr()])
        err = launch(*args, b, q, length, d, layer.multihead_attn.heads, f, int(self_attn),
                     stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder_layer_bwd: CUDA error {err} at launch")
    fused_decoder_layer_bwd.launches += 1
    return dtgt, dmem, dpos, dqpos, grads


fused_decoder_layer_bwd.launches = 0


class _DecoderLayerFn(torch.autograd.Function):
    """Forward kernel, backward kernel; saves the inputs and, when a
    gradient is needed, the memory's k|v (the backward recomputes the
    rest)."""

    @staticmethod
    def forward(ctx, tgt, memory, mask, pos, query_pos, layer, *weights):
        ctx.layer = layer
        out, kv = _forward_kernel(tgt, memory, mask, pos, query_pos, layer, weights,
                                  layer.self_attn is not None)
        ctx.save_for_backward(tgt, memory, mask, pos, query_pos,
                              kv if any(ctx.needs_input_grad) else None)
        return out

    @staticmethod
    def backward(ctx, g):
        tgt, memory, mask, pos, query_pos, kv = ctx.saved_tensors
        dtgt, dmem, dpos, dqpos, grads = fused_decoder_layer_bwd(
            tgt, memory, mask, pos, query_pos, g.contiguous(), ctx.layer, kv)
        return (dtgt, dmem, None, dpos, dqpos, None, *grads)


def fused_decoder_layer(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                        pos: torch.Tensor, query_pos: torch.Tensor, layer: DetrDecoderLayer,
                        self_attn: Optional[bool] = None) -> torch.Tensor:
    """Post-norm DetrDecoderLayer forward in float32 without dropout (JAX's
    fused_decoder_layer_train).  tgt, query_pos [B, Q, D], memory, pos
    [B, L, D], mask [B, L] (1 = valid) -> [B, Q, D]; differentiable in
    every input but the mask and in the layer's weights.  self_attn, when
    given, must match the layer (JAX's argument of the same name).

    A CPU tensor runs the plain version; a CUDA tensor launches the forward
    kernel (counted in `fused_decoder_layer.launches`), and its gradient
    the backward kernel (`fused_decoder_layer_bwd.launches`), or raises.
    Inputs are made contiguous (the model's query_pos and target are
    broadcast views)."""
    _check_self_attn(layer, self_attn)
    if tgt.device.type == "cpu":
        return fused_decoder_layer_reference(tgt, memory, mask, pos, query_pos, layer)
    tgt, memory, mask, pos, query_pos = (t.contiguous() for t in (tgt, memory, mask, pos,
                                                                   query_pos))
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    weights = _weights(layer, tgt.device)
    return _DecoderLayerFn.apply(tgt, memory, mask, pos, query_pos, layer, *weights)


fused_decoder_layer.launches = 0
