"""Fused temporal-tower layer: the CUDA kernels and their plain version.

`fused_temporal_layer` replaces the Pallas TPU kernels of
mgsv_tpu/ops/pallas/fused_temporal_layer.py: `_fwd_pallas` (the forward,
with its three dropout sites) and, through its autograd Function,
`_bwd_pallas` (the backward, which on the TPU recomputes the forward; here
the training forward keeps its activations, SAVED, for it).  `FusedTemporalTransformer`
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
differentiates that.  `temporal_layer_acts_reference` and
`temporal_layer_bwd_from_acts_reference` are the plain versions of the
training forward's saved set and of the backward that reads it.  The
kernel sources say what bounds them on the card and how they split the
work.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.models.layers import BIG_NEG
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
# What the forward keeps for its backward when a gradient will be taken, in
# the order the kernels take it (csrc/layer_bwd_kernels.cuh, TemporalSaved):
# per row y = LN1(x), qkv [3D], ctx, z = LN2(u), LN1's xhat and 1 / std,
# LN2's, a1 = z W1^T + b1 [F] and h1 = drop_H(gelu(a1)) [F]; and each
# attention row's softmax max and sum, stats [B, H, L, 2].  4,114 floats a
# row at D = 256, F = 1024, H = 8.
SAVED = ("y", "qkv", "ctx", "z", "xh1", "inv1", "xh2", "inv2", "a1", "h1", "stats")

# layer -> (device, weight pointers) of the last weights that passed the check
_checked_weights: "weakref.WeakKeyDictionary[TemporalLayer, tuple]" = (
    weakref.WeakKeyDictionary())


def _masks(x: torch.Tensor, layer: TemporalLayer, rate: float, seed: int):
    """The kernels' Philox masks of this call (None at rate 0)."""
    if rate <= 0.0:
        return None
    b, L, d = x.shape
    return philox.temporal_masks(seed, b, L, d, layer[3][0].out_features, layer[1].heads, rate,
                                 device=x.device)


def fused_temporal_layer_reference(x: torch.Tensor, mask: torch.Tensor,
                                   layer: TemporalLayer, rate: float = 0.0,
                                   seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the layer's forward with the
    kernels' Philox masks (the JAX package's temporal_layer_fwd_with_masks);
    differentiable, so its autograd gradient is the plain version of the
    backward kernel."""
    return layer(x, mask, masks=_masks(x, layer, rate, seed))


def _layer_norm_stats(t: torch.Tensor):
    """(xhat, 1 / std) of LayerNorm over the last axis (eps 1e-5)."""
    mean = t.mean(-1, keepdim=True)
    inv = torch.rsqrt((t - mean).pow(2).mean(-1, keepdim=True) + 1e-5)
    return (t - mean) * inv, inv[..., 0]


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, L, d = t.shape
    return t.reshape(b, L, heads, d // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, L, dh = t.shape
    return t.transpose(1, 2).reshape(b, L, h * dh)


def temporal_layer_acts_reference(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer,
                                  rate: float = 0.0, seed: int = 0):
    """Plain version of what the forward kernel's training variant keeps:
    (out, the SAVED tensors in that order), from the layer's weights and
    the kernels' Philox masks.  stats holds each attention row's softmax
    max and sum over its scaled scores (masked keys at -1e9)."""
    norm1, attn, norm2, ff = layer
    masks = _masks(x, layer, rate, seed) or {}
    heads = attn.heads
    xh1, inv1 = _layer_norm_stats(x)
    y = xh1 * norm1.weight + norm1.bias
    qkv = F.linear(y, attn.in_proj_weight, attn.in_proj_bias)
    q, k, v = (_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, None, :] != 0, scores, torch.full_like(scores, BIG_NEG))
    mx = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - mx)
    total = e.sum(-1, keepdim=True)
    p = e / total
    if "attn" in masks:
        p = p * masks["attn"]
    ctx = _merge(p @ v)
    u = y + attn.out_proj(ctx)
    xh2, inv2 = _layer_norm_stats(u)
    z = xh2 * norm2.weight + norm2.bias
    a1 = ff[0](z)
    h1 = ff[1](a1)
    if "ffn1" in masks:
        h1 = h1 * masks["ffn1"]
    o = ff[3](h1)
    if "ffn2" in masks:
        o = o * masks["ffn2"]
    stats = torch.stack([mx[..., 0], total[..., 0]], dim=-1)
    acts = dict(y=y, qkv=qkv, ctx=ctx, z=z, xh1=xh1, inv1=inv1, xh2=xh2, inv2=inv2, a1=a1,
                h1=h1, stats=stats)
    return o + z, tuple(acts[name] for name in SAVED)


def _layer_norm_bwd(dy: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor,
                    gamma: torch.Tensor) -> torch.Tensor:
    dxh = dy * gamma
    return inv[..., None] * (dxh - dxh.mean(-1, keepdim=True)
                             - xhat * (dxh * xhat).mean(-1, keepdim=True))


def _rows_sum(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).sum(0)


def _wgrad(gr: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return gr.reshape(-1, gr.shape[-1]).T @ h.reshape(-1, h.shape[-1])


def temporal_layer_bwd_from_acts_reference(x: torch.Tensor, mask: torch.Tensor,
                                           g: torch.Tensor, layer: TemporalLayer, acts,
                                           rate: float = 0.0, seed: int = 0):
    """Plain version of the backward kernel given `acts` (SAVED's tensors,
    as `temporal_layer_acts_reference` returns them): (dx, the gradients of
    `_layer_tensors(layer)`), derived by hand as the kernel source states
    them, from x's shape, the mask, g, the weights, the Philox masks and
    `acts` alone.  The attention weights are rebuilt from the saved
    statistics; D_i = dctx_i . ctx_i; the scores of masked keys are
    constants, so their ds is 0."""
    y, qkv, ctx, z, xh1, inv1, xh2, inv2, a1, h1, stats = acts
    (w_in, _, w_out, _, g1, _, w1, _, w2, _, g2, _) = _layer_tensors(layer)
    masks = _masks(x, layer, rate, seed) or {}
    heads = layer[1].heads
    # the FFN
    dh2 = g * masks["ffn2"] if "ffn2" in masks else g
    db2, dw2 = _rows_sum(dh2), _wgrad(dh2, h1)
    dh1 = dh2 @ w2
    if "ffn1" in masks:
        dh1 = dh1 * masks["ffn1"]
    phi = 0.5 * (1.0 + torch.erf(a1 / math.sqrt(2.0)))
    da = dh1 * (phi + a1 * torch.exp(-0.5 * a1 * a1) / math.sqrt(2.0 * math.pi))
    db1, dw1 = _rows_sum(da), _wgrad(da, z)
    dz = g + da @ w1
    # LN2 and the attention's output projection
    dg2, dbe2 = _rows_sum(dz * xh2), _rows_sum(dz)
    du = _layer_norm_bwd(dz, xh2, inv2, g2)
    dbo, dwo = _rows_sum(du), _wgrad(du, ctx)
    dctx = du @ w_out
    # the attention, its weights rebuilt from the forward's statistics
    q, k, v = (_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    do = _heads(dctx, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = mask[:, None, None, :] != 0
    scores = torch.where(valid, (q @ k.transpose(-1, -2)) * scale,
                         torch.full((), BIG_NEG, dtype=q.dtype, device=q.device))
    p = torch.exp(scores - stats[..., :1]) / stats[..., 1:]
    keep = masks.get("attn")
    pm = p * keep if keep is not None else p
    dp = do @ v.transpose(-1, -2)
    dpm = dp * keep if keep is not None else dp
    dd = (do * _heads(ctx, heads)).sum(-1, keepdim=True)
    ds = torch.where(valid, p * (dpm - dd), torch.zeros((), dtype=p.dtype, device=p.device))
    dqkv = torch.cat([_merge(ds @ k) * scale, _merge(ds.transpose(-1, -2) @ q) * scale,
                      _merge(pm.transpose(-1, -2) @ do)], dim=-1)
    db_in, dw_in = _rows_sum(dqkv), _wgrad(dqkv, y)
    # the input projection and LN1
    dy = du + dqkv @ w_in
    dg1, dbe1 = _rows_sum(dy * xh1), _rows_sum(dy)
    dx = _layer_norm_bwd(dy, xh1, inv1, g1)
    return dx, [dw_in, db_in, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2]


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
    size.argtypes = [ctypes.c_int] * 3
    fn = lib.mgsv_fused_temporal_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return size, fn


@functools.cache
def _bwd_launcher(device_index: int):
    """The backward's C entry points (workspace size, launch)."""
    lib = kernels.load_initialized("fused_temporal_layer_bwd", device_index)
    size = lib.mgsv_fused_temporal_layer_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 3
    fn = lib.mgsv_fused_temporal_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 5
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    return size, fn


def _saved_shapes(b: int, length: int, f: int, heads: int) -> tuple:
    """The shapes of SAVED's tensors for x [b, length, DIM] and FFN width f."""
    rows = (b, length)
    widths = {"qkv": 3 * DIM, "a1": f, "h1": f}
    return tuple((b, heads, length, 2) if name == "stats"
                 else rows if name.startswith("inv") else rows + (widths.get(name, DIM),)
                 for name in SAVED)


def _pointer_array(tensors):
    """A C array of the tensors' device pointers (SAVED's order), or None."""
    if tensors is None:
        return None
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _forward_kernel(x, mask, layer, weights, rate, seed, save: bool):
    """out, and with `save` the SAVED tensors the launch wrote (else None)."""
    (b, L, d), f, heads = x.shape, weights[6].shape[0], layer[1].heads
    out = torch.empty_like(x)
    acts = (tuple(x.new_empty(shape) for shape in _saved_shapes(b, L, f, heads))
            if save else None)
    with torch.cuda.device(x.device):
        size, launch = _launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f, int(save))))
        saved = _pointer_array(acts)
        args = [t.data_ptr() for t in (x, mask) + tuple(weights) + (ws, out)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*args, saved, b, L, d, heads, f, *philox.kernel_args(rate, seed), stream)
    if err != 0:
        raise RuntimeError(f"fused_temporal_layer: CUDA error {err} at launch")
    fused_temporal_layer.launches += 1
    return out, acts


def fused_temporal_layer_fwd(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer,
                             rate: float = 0.0, seed: int = 0):
    """The forward kernel's training variant, as autograd runs it: (out,
    the SAVED tensors its backward takes as `acts`).  CUDA tensors only;
    `temporal_layer_acts_reference` is its plain version."""
    if x.device.type != "cuda":
        raise ValueError("fused_temporal_layer_fwd: the kernel takes CUDA tensors; on the "
                         "CPU use temporal_layer_acts_reference")
    _check_inputs(x, mask, layer)
    return _forward_kernel(x, mask, layer, _weights(layer, x.device), rate, seed, save=True)


def _check_acts(acts, x: torch.Tensor, layer: TemporalLayer, f: int) -> None:
    want = _saved_shapes(*x.shape[:2], f, layer[1].heads)
    if len(acts) != len(SAVED):
        raise ValueError(f"fused_temporal_layer_bwd: acts holds {len(acts)} tensors, "
                         f"not the {len(SAVED)} of {SAVED}")
    _check_tensors(acts, x.device)
    for name, t, shape in zip(SAVED, acts, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_temporal_layer_bwd: acts {name} {tuple(t.shape)}, "
                             f"want {shape}")


def fused_temporal_layer_bwd(x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                             layer: TemporalLayer, rate: float = 0.0, seed: int = 0,
                             acts=None):
    """Backward of the layer: (dx, gradients of the 12 tensors of
    `_layer_tensors(layer)`, in that order), from `acts` (the SAVED tensors
    of `fused_temporal_layer_fwd` on the same inputs, rate and seed) or,
    without them, by recompute: the same bits either way.  CUDA tensors
    only: the plain version of this kernel is autograd through
    `fused_temporal_layer_reference`, or `temporal_layer_bwd_from_acts_reference`."""
    if x.device.type != "cuda":
        raise ValueError("fused_temporal_layer_bwd: the kernel takes CUDA tensors; "
                         "on the CPU differentiate fused_temporal_layer_reference")
    _check_inputs(x, mask, layer)
    _check_tensors((g,), x.device)
    if g.shape != x.shape:
        raise ValueError(f"fused_temporal_layer_bwd: g {tuple(g.shape)} vs x {tuple(x.shape)}")
    weights = _weights(layer, x.device)
    (b, L, d), f = x.shape, weights[6].shape[0]
    if acts is not None:
        _check_acts(acts, x, layer, f)
    grads = [torch.empty_like(w) for w in weights]
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        size, launch = _bwd_launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f, int(acts is not None))))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        saved = _pointer_array(acts)
        args = [t.data_ptr() for t in (x, mask, g) + tuple(weights) + (dx,) + tuple(grads)]
        err = launch(*args, saved, ws.data_ptr(), b, L, d, layer[1].heads, f,
                     *philox.kernel_args(rate, seed), stream)
    if err != 0:
        raise RuntimeError(f"fused_temporal_layer_bwd: CUDA error {err} at launch")
    fused_temporal_layer_bwd.launches += 1
    return dx, grads


fused_temporal_layer_bwd.launches = 0


class _TemporalLayerFn(torch.autograd.Function):
    """Forward kernel, backward kernel.  With a gradient to take, the
    forward keeps its activations (SAVED) for the backward; without one it
    saves nothing (no masks and no [L, L] weights are ever stored)."""

    @staticmethod
    def forward(ctx, x, mask, layer, rate, seed, train, *weights):
        ctx.layer, ctx.rate, ctx.seed = layer, rate, seed
        out, acts = _forward_kernel(x, mask, layer, weights, rate, seed, save=train)
        if train:
            ctx.save_for_backward(x, mask, *acts)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, *acts = ctx.saved_tensors
        dx, grads = fused_temporal_layer_bwd(x, mask, g.contiguous(), ctx.layer, ctx.rate,
                                             ctx.seed, acts=acts)
        return (dx, None, None, None, None, None, *grads)


def fused_temporal_layer(x: torch.Tensor, mask: torch.Tensor, layer: TemporalLayer,
                         rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """The temporal layer with dropout `rate` drawn from the Philox stream
    `seed` (ops/philox.py).  x [B, L, D] float32, mask [B, L] float32
    (1 = valid) -> [B, L, D]; differentiable.

    A CPU tensor runs the plain version; a CUDA tensor launches the forward
    kernel (counted in `fused_temporal_layer.launches`), and its gradient
    the backward kernel (`fused_temporal_layer_bwd.launches`), or raises.
    The forward keeps its activations for the backward only where a
    gradient will be taken (grad mode on, and x or a weight requiring one)."""
    if x.device.type == "cpu":
        return fused_temporal_layer_reference(x, mask, layer, rate, seed)
    _check_inputs(x, mask, layer)
    weights = _weights(layer, x.device)
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights))
    return _TemporalLayerFn.apply(x, mask, layer, rate, seed, train, *weights)


fused_temporal_layer.launches = 0
