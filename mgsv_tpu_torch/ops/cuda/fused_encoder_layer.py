"""Fused post-norm DETR encoder layer: the CUDA kernel and its plain version.

`fused_encoder_layer` replaces the Pallas TPU kernels
mgsv_tpu/ops/pallas/fused_encoder_layer.py::fused_encoder_layer (forward,
with its four dropout sites) and, through its autograd Function,
mgsv_tpu/ops/pallas/fused_encoder_layer_vjp.py::_bwd_pallas (the backward,
which on the TPU recomputes the forward; here the training forward keeps
its activations, SAVED, for it): the serving path runs it at rate 0,
training at the configuration's rate.  On a CUDA tensor it launches
csrc/fused_encoder_layer.cu and, for the gradient,
csrc/fused_encoder_layer_bwd.cu (built at first use, see
runtime/kernels.py), or raises; on a CPU tensor it runs
`fused_encoder_layer_reference`, the layer's own plain PyTorch forward with
the same Philox masks, and autograd differentiates that.
`encoder_layer_acts_reference` and `encoder_layer_bwd_from_acts_reference`
are the plain versions of the training forward's saved set and of the
backward that reads it.  The kernel sources say what bounds them on the
card and how they split the work.

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
from mgsv_tpu_torch.ops.cuda.fused_temporal_layer import (_heads, _layer_norm_bwd,
                                                          _layer_norm_stats, _merge,
                                                          _pointer_array, _rows_sum, _wgrad)
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
# What the forward keeps for its backward when a gradient will be taken, in
# the order the kernels take it (csrc/layer_bwd_kernels.cuh, EncoderSaved):
# per row a = x + pos, qkv [3D], ctx, y1 = LN1(x + o), h1 [F] (the dropped
# ReLU, whose sign is the gate), LN1's xhat and 1 / std, LN2's; and each
# attention row's softmax max and sum, stats [B, H, L, 2].  3,090 floats a
# row at D = 256, F = 1024, H = 8.
SAVED = ("a", "qkv", "ctx", "y1", "h1", "xh1", "inv1", "xh2", "inv2", "stats")

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


def _masks(x: torch.Tensor, layer: DetrEncoderLayer, rate: float, seed: int):
    """The kernels' Philox masks of this call (None at rate 0)."""
    if rate <= 0.0:
        return None
    b, L, d = x.shape
    return philox.encoder_masks(seed, b, L, d, layer.linear1.out_features,
                                layer.self_attn.heads, rate, device=x.device)


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
    masks = _masks(x, layer, rate, seed)
    with torch.autocast(x.device.type, enabled=False):
        if precision == "bf16":
            return _bf16_layer(x, mask, pos, layer, masks)
        return layer(x, mask, pos, masks)


def _product(precision: str):
    """(a, b, scale) -> (a @ b) * scale, at "bf16" with both operands
    rounded to bf16 (`bf16_matmul`, whose backward rounds each product's
    operands the same way)."""
    if precision == "bf16":
        return bf16_matmul
    return lambda a, b, scale=1.0: (a @ b) * scale


def encoder_layer_acts_reference(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                                 layer: DetrEncoderLayer, rate: float = 0.0, seed: int = 0,
                                 precision: str = "f32"):
    """Plain version of what the forward kernel's training variant keeps:
    (out, the SAVED tensors in that order), from the layer's weights and
    the kernel's Philox masks, each product at `precision` as
    `fused_encoder_layer_reference` takes it.  stats holds each attention
    row's softmax max and sum over its scaled scores (masked keys at -1e9)."""
    _check_precision(precision)
    mm, sa = _product(precision), layer.self_attn
    masks = _masks(x, layer, rate, seed) or {}
    wq, wk, wv = sa.in_proj_weight.chunk(3, dim=0)
    bq, bk, bv = sa.in_proj_bias.chunk(3, dim=0)
    a = x + pos
    qkv = torch.cat([mm(a, wq.T) + bq, mm(a, wk.T) + bk, mm(x, wv.T) + bv], dim=-1)
    q, k, v = (_heads(t, sa.heads) for t in qkv.chunk(3, dim=-1))
    scores = mm(q, k.transpose(-1, -2), 1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask[:, None, None, :] != 0, scores, torch.full_like(scores, BIG_NEG))
    mx = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - mx)
    total = e.sum(-1, keepdim=True)
    p = e / total
    if "attn" in masks:
        p = p * masks["attn"]
    ctx = _merge(mm(p, v))
    o = mm(ctx, sa.out_proj.weight.T) + sa.out_proj.bias
    if "attn_out" in masks:
        o = o * masks["attn_out"]
    xh1, inv1 = _layer_norm_stats(x + o)
    y1 = xh1 * layer.norm1.weight + layer.norm1.bias
    h1 = F.relu(mm(y1, layer.linear1.weight.T) + layer.linear1.bias)
    if "ffn1" in masks:
        h1 = h1 * masks["ffn1"]
    h2 = mm(h1, layer.linear2.weight.T) + layer.linear2.bias
    if "ffn2" in masks:
        h2 = h2 * masks["ffn2"]
    xh2, inv2 = _layer_norm_stats(y1 + h2)
    stats = torch.stack([mx[..., 0], total[..., 0]], dim=-1)
    acts = dict(a=a, qkv=qkv, ctx=ctx, y1=y1, h1=h1, xh1=xh1, inv1=inv1, xh2=xh2, inv2=inv2,
                stats=stats)
    return xh2 * layer.norm2.weight + layer.norm2.bias, tuple(acts[name] for name in SAVED)


def encoder_layer_bwd_from_acts_reference(x: torch.Tensor, mask: torch.Tensor,
                                          pos: torch.Tensor, g: torch.Tensor,
                                          layer: DetrEncoderLayer, acts, rate: float = 0.0,
                                          seed: int = 0, precision: str = "f32"):
    """Plain version of the backward kernel given `acts` (SAVED's tensors,
    as `encoder_layer_acts_reference` returns them): (dx, dpos, the
    gradients of `_layer_tensors(layer)`), derived by hand as the kernel
    source states them, from x, the mask, g, the weights, the Philox masks
    and `acts` alone (pos enters through a = x + pos).  At "bf16" every
    product rounds both operands to bf16, as autograd through `_Bf16Matmul`
    does.  The attention weights are rebuilt from the saved statistics;
    D_i = dctx_i . ctx_i at "f32", sum_j p_ij dp_ij at "bf16" (as the
    kernel's attention takes it there: ctx is a product of rounded
    operands); the scores of masked keys are constants, so their ds is 0;
    the ReLU gate is h1 > 0."""
    _check_precision(precision)
    a, qkv, ctx, y1, h1, xh1, inv1, xh2, inv2, stats = acts
    (w_in, _, w_out, _, g1, _, w1, _, w2, _, g2, _) = _layer_tensors(layer)
    mm = _product(precision)
    wg = (lambda gr, h: _wgrad(_bf16(gr), _bf16(h))) if precision == "bf16" else _wgrad
    masks = _masks(x, layer, rate, seed) or {}
    heads = layer.self_attn.heads
    # LN2 and the FFN
    dg2, dbe2 = _rows_sum(g * xh2), _rows_sum(g)
    dr2 = _layer_norm_bwd(g, xh2, inv2, g2)
    dh2 = dr2 * masks["ffn2"] if "ffn2" in masks else dr2
    db2, dw2 = _rows_sum(dh2), wg(dh2, h1)
    dh1 = mm(dh2, w2)
    if "ffn1" in masks:
        dh1 = dh1 * masks["ffn1"]
    dz1 = torch.where(h1 > 0, dh1, torch.zeros((), dtype=dh1.dtype, device=dh1.device))
    db1, dw1 = _rows_sum(dz1), wg(dz1, y1)
    dy1 = dr2 + mm(dz1, w1)
    # LN1 and the attention's output projection
    dg1, dbe1 = _rows_sum(dy1 * xh1), _rows_sum(dy1)
    dr1 = _layer_norm_bwd(dy1, xh1, inv1, g1)
    do = dr1 * masks["attn_out"] if "attn_out" in masks else dr1
    dbo, dwo = _rows_sum(do), wg(do, ctx)
    dctx = mm(do, w_out)
    # the attention, its weights rebuilt from the forward's statistics
    q, k, v = (_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    dc = _heads(dctx, heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = mask[:, None, None, :] != 0
    scores = torch.where(valid, mm(q, k.transpose(-1, -2), scale),
                         torch.full((), BIG_NEG, dtype=q.dtype, device=q.device))
    p = torch.exp(scores - stats[..., :1]) / stats[..., 1:]
    keep = masks.get("attn")
    pm = p * keep if keep is not None else p
    dpm = mm(dc, v.transpose(-1, -2))
    dp = dpm * keep if keep is not None else dpm
    if precision == "bf16":
        dd = (p * dp).sum(-1, keepdim=True)
    else:
        dd = (dc * _heads(ctx, heads)).sum(-1, keepdim=True)
    ds = torch.where(valid, p * (dp - dd), torch.zeros((), dtype=p.dtype, device=p.device))
    dq, dk = _merge(mm(ds, k, scale)), _merge(mm(ds.transpose(-1, -2), q, scale))
    dv = _merge(mm(pm.transpose(-1, -2), dc))
    db_in = _rows_sum(torch.cat([dq, dk, dv], dim=-1))
    dw_in = torch.cat([wg(dq, a), wg(dk, a), wg(dv, x)])
    # the input projections: dpos = dq Wq + dk Wk; dx = dv Wv + dpos + dr1
    wq, wk, wv = w_in.chunk(3, dim=0)
    dpos = mm(dq, wq) + mm(dk, wk)
    dx = mm(dv, wv) + dpos + dr1
    return dx, dpos, [dw_in, db_in, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2]


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
    size.argtypes = [ctypes.c_int] * 3
    fn = lib.mgsv_fused_encoder_layer_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return size, fn


@functools.cache
def _bwd_launcher(device_index: int):
    """The backward's C entry points (workspace size, launch)."""
    lib = kernels.load_initialized("fused_encoder_layer_bwd", device_index)
    size = lib.mgsv_fused_encoder_layer_bwd_workspace
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 3
    fn = lib.mgsv_fused_encoder_layer_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 32 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return size, fn


def _saved_shapes(b: int, length: int, f: int, heads: int) -> tuple:
    """The shapes of SAVED's tensors for x [b, length, DIM] and FFN width f."""
    rows = (b, length)
    widths = {"qkv": 3 * DIM, "h1": f}
    return tuple((b, heads, length, 2) if name == "stats"
                 else rows if name.startswith("inv") else rows + (widths.get(name, DIM),)
                 for name in SAVED)


def _forward_kernel(x, mask, pos, layer, weights, rate, seed, precision, save: bool):
    """out, and with `save` the SAVED tensors the launch wrote (else None)."""
    (b, L, d), f, heads = x.shape, weights[6].shape[0], layer.self_attn.heads
    out = torch.empty_like(x)
    acts = (tuple(x.new_empty(shape) for shape in _saved_shapes(b, L, f, heads))
            if save else None)
    seed = philox.device_seed(seed, rate, x.device)
    with torch.cuda.device(x.device):
        size, launch = _launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f, int(save))))
        args = [t.data_ptr() for t in (x, pos, mask) + tuple(weights) + (ws, out)]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(*args, _pointer_array(acts), b, L, d, heads, f,
                     *philox.kernel_args(rate, seed), int(precision == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer: CUDA error {err} at launch")
    fused_encoder_layer.launches += 1
    return out, acts


def fused_encoder_layer_fwd(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                            layer: DetrEncoderLayer, rate: float = 0.0, seed: int = 0,
                            precision: str = "f32"):
    """The forward kernel's training variant, as autograd runs it: (out,
    the SAVED tensors its backward takes as `acts`).  CUDA tensors only;
    `encoder_layer_acts_reference` is its plain version."""
    _check_precision(precision)
    if x.device.type != "cuda":
        raise ValueError("fused_encoder_layer_fwd: the kernel takes CUDA tensors; on the "
                         "CPU use encoder_layer_acts_reference")
    _check_inputs(x, mask, pos, layer)
    return _forward_kernel(x, mask, pos, layer, _weights(layer, x.device), rate, seed,
                           precision, save=True)


def _check_acts(acts, x: torch.Tensor, layer: DetrEncoderLayer, f: int) -> None:
    want = _saved_shapes(*x.shape[:2], f, layer.self_attn.heads)
    if len(acts) != len(SAVED):
        raise ValueError(f"fused_encoder_layer_bwd: acts holds {len(acts)} tensors, "
                         f"not the {len(SAVED)} of {SAVED}")
    _check_tensors(acts, x.device)
    for name, t, shape in zip(SAVED, acts, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_encoder_layer_bwd: acts {name} {tuple(t.shape)}, "
                             f"want {shape}")


def fused_encoder_layer_bwd(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                            g: torch.Tensor, layer: DetrEncoderLayer,
                            rate: float = 0.0, seed: int = 0, precision: str = "f32",
                            acts=None):
    """Backward of the layer: (dx, dpos, gradients of the 12 tensors of
    `_layer_tensors(layer)`, in that order), from `acts` (the SAVED tensors
    of `fused_encoder_layer_fwd` on the same inputs, rate, seed and
    precision) or, without them, by recompute: the same bits either way.
    CUDA tensors only: the plain version of this kernel is autograd through
    `fused_encoder_layer_reference`, or `encoder_layer_bwd_from_acts_reference`."""
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
    if acts is not None:
        _check_acts(acts, x, layer, f)
    grads = [torch.empty_like(w) for w in weights]
    dx, dpos = torch.empty_like(x), torch.empty_like(x)
    seed = philox.device_seed(seed, rate, x.device)
    with torch.cuda.device(x.device):
        size, launch = _bwd_launcher(x.device.index)
        ws = x.new_empty(int(size(b * L, f, int(acts is not None))))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [t.data_ptr() for t in (x, pos, mask, g) + tuple(weights)
                + (dx, dpos) + tuple(grads)]
        err = launch(*args, _pointer_array(acts), ws.data_ptr(), b, L, d,
                     layer.self_attn.heads, f, *philox.kernel_args(rate, seed),
                     int(precision == "bf16"), stream)
    if err != 0:
        raise RuntimeError(f"fused_encoder_layer_bwd: CUDA error {err} at launch")
    fused_encoder_layer_bwd.launches += 1
    return dx, dpos, grads


fused_encoder_layer_bwd.launches = 0


class _EncoderLayerFn(torch.autograd.Function):
    """Forward kernel #1, backward kernel #2.  With a gradient to take, the
    forward keeps its activations (SAVED) for the backward, which reads them
    instead of recomputing the forward; without one it saves nothing (no
    masks and no [L, L] weights are ever stored)."""

    @staticmethod
    def forward(ctx, x, mask, pos, layer, rate, seed, precision, train, *weights):
        ctx.layer, ctx.rate, ctx.seed, ctx.precision = layer, rate, seed, precision
        out, acts = _forward_kernel(x, mask, pos, layer, weights, rate, seed, precision,
                                    save=train)
        if train:
            ctx.save_for_backward(x, mask, pos, *acts)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mask, pos, *acts = ctx.saved_tensors
        dx, dpos, grads = fused_encoder_layer_bwd(x, mask, pos, g.contiguous(), ctx.layer,
                                                  ctx.rate, ctx.seed, ctx.precision,
                                                  acts=acts)
        return (dx, None, dpos, None, None, None, None, None, *grads)


def fused_encoder_layer(x: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor,
                        layer: DetrEncoderLayer, rate: float = 0.0,
                        seed: int = 0, precision: str = "f32") -> torch.Tensor:
    """Post-norm DetrEncoderLayer forward with dropout `rate` drawn from the
    Philox stream `seed` (ops/philox.py), at `precision` ("f32" | "bf16").
    x, pos [B, L, D] float32, mask [B, L] float32 (1 = valid) -> [B, L, D];
    differentiable.

    A CPU tensor runs the plain version; a CUDA tensor launches the forward
    kernel (counted in `fused_encoder_layer.launches`), and its gradient
    the backward kernel (`fused_encoder_layer_bwd.launches`), or raises.
    The forward keeps its activations for the backward only where a
    gradient will be taken (grad mode on, and x, pos or a weight requiring
    one)."""
    _check_precision(precision)
    if x.device.type == "cpu":
        return fused_encoder_layer_reference(x, mask, pos, layer, rate, seed, precision)
    _check_inputs(x, mask, pos, layer)
    weights = _weights(layer, x.device)
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (x, pos, *weights))
    return _EncoderLayerFn.apply(x, mask, pos, layer, rate, seed, precision, train, *weights)


fused_encoder_layer.launches = 0
