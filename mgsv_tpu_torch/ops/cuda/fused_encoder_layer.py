"""Fused post-norm DETR encoder layer: the CUDA kernel and its plain version.

`fused_encoder_layer` replaces the Pallas TPU kernel
mgsv_tpu/ops/pallas/fused_encoder_layer.py::fused_encoder_layer at dropout
rate 0 (the serving path).  On a CUDA tensor it launches
csrc/fused_encoder_layer.cu (built at first use, see runtime/kernels.py) or
raises; on a CPU tensor it runs `fused_encoder_layer_reference`, the layer's
own plain PyTorch forward.  The kernel source says what bounds it on the
card and how its three launches split the work.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.runtime import kernels

# The shapes the kernel takes; csrc/fused_encoder_layer.cu guards the same.
HEAD_DIM = 32      # the kernel maps one lane to one head channel
DIM = 256          # its GEMM tiles span a full row of D = 256 (for LayerNorm)
MAX_L = 256        # the attention block's shared memory is sized for this L
MAX_B = 65535      # grid y of the attention launch

# layer -> (device, weight pointers) of the last weights that passed the check
_checked_weights: "weakref.WeakKeyDictionary[DetrEncoderLayer, tuple]" = (
    weakref.WeakKeyDictionary())


def fused_encoder_layer_reference(x: torch.Tensor, mask: torch.Tensor,
                                  pos: torch.Tensor,
                                  layer: DetrEncoderLayer) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the module's forward (the JAX
    package's layer_fwd_with_masks with masks=None)."""
    return layer(x, mask, pos)


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
    """The kernel's C entry point, with the kernels' shared-memory limits
    set once on this device (call with the device current)."""
    lib = kernels.load("fused_encoder_layer")
    lib.mgsv_fused_encoder_layer_init.restype = ctypes.c_int
    err = lib.mgsv_fused_encoder_layer_init()
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer: CUDA error {err} in init "
                           f"on cuda:{device_index}")
    fn = lib.mgsv_fused_encoder_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def fused_encoder_layer(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                        layer: DetrEncoderLayer) -> torch.Tensor:
    """Post-norm DetrEncoderLayer forward.  x, pos [B, L, D] float32,
    mask [B, L] float32 (1 = valid) -> [B, L, D].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (and counts the launch in `fused_encoder_layer.launches`) or raises."""
    if x.device.type == "cpu":
        return fused_encoder_layer_reference(x, mask, pos, layer)
    _check_inputs(x, mask, pos, layer)
    weights = _weights(layer, x.device)
    (b, L, d), f = x.shape, weights[6].shape[0]
    qkv = x.new_empty(b, L, 3 * d)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    args = [t.data_ptr() for t in (x, pos, mask) + weights + (qkv, ctx, out)]
    with torch.cuda.device(x.device):
        launch = _launcher(x.device.index)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*args, b, L, d, layer.self_attn.heads, f, stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer: CUDA error {err} at launch")
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
