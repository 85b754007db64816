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
layer needs a gradient, the forward keeps what the backward reads (SAVED:
the memory's k|v, 159 MB at B=512 and L=152, and the query side's
activations, 79 MB at Q=10), and the backward then recomputes nothing.
`decoder_layer_acts_reference` and `decoder_layer_bwd_from_acts_reference`
are the plain versions of that set and of the backward that reads it.  The
kernel sources say what bounds them on the card and how they split the
work.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import TYPE_CHECKING, Optional

import torch
import torch.nn.functional as F

from mgsv_tpu_torch.models.layers import BIG_NEG
# the plain backward's pieces the temporal layer's (#5) plain version shares
from mgsv_tpu_torch.ops.cuda.fused_temporal_layer import (_heads, _layer_norm_bwd,
                                                          _layer_norm_stats, _merge, _rows_sum,
                                                          _wgrad)
from mgsv_tpu_torch.runtime import kernels

if TYPE_CHECKING:
    from mgsv_tpu_torch.models.detr import DetrDecoderLayer

# The shapes the kernels take; csrc/decoder_layer_kernels.cuh guards the same.
HEAD_DIM = 32      # the attention maps one lane to one head channel
DIM = 256          # the LayerNorm launches take rows of D = 256, 8 values a lane
MAX_L = 256        # memory rows and queries: the attention's shared memory
MAX_B = 65535      # grid y of the attention launches
# What the forward keeps for its backward when a gradient will be taken, in
# the order the kernels take it (csrc/decoder_layer_kernels.cuh,
# DecoderSaved): the memory's k|v [B, L, 2D]; with self-attention its q|k|v
# [3D], context, softmax statistics and t1 = LN1(.) with LN1's xhat and
# 1 / std (None without self-attention); the cross-attention's q, context
# and statistics; t2 = LN2(.) with its xhat and 1 / std; h1 = relu(FFN1)
# [F]; LN3's xhat and 1 / std.  Each statistics tensor holds the softmax
# max and sum of exp of each query row, [B, H, Q, 2].  3,875 floats a query
# row with self-attention at D = 256, F = 1024, H = 8.
SAVED = ("kv", "sa_qkv", "sa_ctx", "sa_stats", "t1", "xh1", "inv1", "q", "ctx", "stats",
         "t2", "xh2", "inv2", "h1", "xh3", "inv3")
_SELF_ATTN_SAVED = frozenset(("sa_qkv", "sa_ctx", "sa_stats", "t1", "xh1", "inv1"))

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


def _attention_acts(q, k, v, key_mask, heads: int):
    """(ctx, stats [B, H, Lq, 2]) of softmax attention, masked keys at -1e9."""
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :] != 0, scores,
                             torch.full_like(scores, BIG_NEG))
    mx = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - mx)
    total = e.sum(-1, keepdim=True)
    return _merge((e / total) @ vh), torch.stack([mx[..., 0], total[..., 0]], dim=-1)


def decoder_layer_acts_reference(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                                 pos: torch.Tensor, query_pos: torch.Tensor,
                                 layer: DetrDecoderLayer):
    """Plain version of what the forward kernel's training variant keeps:
    (out, the SAVED tensors in that order, None where the layer has no
    self-attention), from the layer's weights in the inputs' dtype."""
    heads = layer.multihead_attn.heads
    acts = dict.fromkeys(SAVED)
    t1 = tgt
    if layer.self_attn is not None:
        sa = layer.self_attn
        a = tgt + query_pos
        w_q, w_k, w_v = sa.in_proj_weight.chunk(3)
        b_q, b_k, b_v = sa.in_proj_bias.chunk(3)
        qkv = torch.cat([F.linear(a, w_q, b_q), F.linear(a, w_k, b_k), F.linear(tgt, w_v, b_v)],
                        dim=-1)
        sa_ctx, sa_stats = _attention_acts(*qkv.chunk(3, dim=-1), None, heads)
        xh1, inv1 = _layer_norm_stats(tgt + sa.out_proj(sa_ctx))
        t1 = xh1 * layer.norm1.weight + layer.norm1.bias
        acts.update(sa_qkv=qkv, sa_ctx=sa_ctx, sa_stats=sa_stats, t1=t1, xh1=xh1, inv1=inv1)
    ca = layer.multihead_attn
    w_q, w_k, w_v = ca.in_proj_weight.chunk(3)
    b_q, b_k, b_v = ca.in_proj_bias.chunk(3)
    kv = torch.cat([F.linear(memory + pos, w_k, b_k), F.linear(memory, w_v, b_v)], dim=-1)
    q = F.linear(t1 + query_pos, w_q, b_q)
    ctx, stats = _attention_acts(q, *kv.chunk(2, dim=-1), mask, heads)
    xh2, inv2 = _layer_norm_stats(t1 + ca.out_proj(ctx))
    t2 = xh2 * layer.norm2.weight + layer.norm2.bias
    h1 = torch.relu(layer.linear1(t2))
    xh3, inv3 = _layer_norm_stats(t2 + layer.linear2(h1))
    acts.update(kv=kv, q=q, ctx=ctx, stats=stats, t2=t2, xh2=xh2, inv2=inv2, h1=h1, xh3=xh3,
                inv3=inv3)
    out = xh3 * layer.norm3.weight + layer.norm3.bias
    return out, tuple(acts[name] for name in SAVED)


def _attention_bwd(q, k, v, dctx, ctx, stats, key_mask, heads: int):
    """(dq, dk, dv) of softmax attention from the forward's statistics: the
    weights rebuilt as exp(s - max) / sum, D_i = dctx_i . ctx_i; a masked
    key's score is a constant, so its ds is 0 (it still gets dv)."""
    qh, kh, vh, do = (_heads(t, heads) for t in (q, k, v, dctx))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    scores = (qh @ kh.transpose(-1, -2)) * scale
    valid = None
    if key_mask is not None:
        valid = key_mask[:, None, None, :] != 0
        scores = torch.where(valid, scores, torch.full((), BIG_NEG, dtype=q.dtype,
                                                       device=q.device))
    p = torch.exp(scores - stats[..., :1]) / stats[..., 1:]
    dd = (do * _heads(ctx, heads)).sum(-1, keepdim=True)
    ds = p * (do @ vh.transpose(-1, -2) - dd)
    if valid is not None:
        ds = torch.where(valid, ds, torch.zeros((), dtype=ds.dtype, device=ds.device))
    return (_merge(ds @ kh) * scale, _merge(ds.transpose(-1, -2) @ qh) * scale,
            _merge(p.transpose(-1, -2) @ do))


def decoder_layer_bwd_from_acts_reference(tgt: torch.Tensor, memory: torch.Tensor,
                                          mask: torch.Tensor, pos: torch.Tensor,
                                          query_pos: torch.Tensor, g: torch.Tensor,
                                          layer: DetrDecoderLayer, acts):
    """Plain version of the backward kernel given `acts` (SAVED's tensors,
    as `decoder_layer_acts_reference` returns them): (dtgt, dmemory, dpos,
    dquery_pos, the gradients of `_layer_tensors(layer)`), derived by hand
    as the kernel source states them, from the inputs, the mask, g, the
    weights and `acts` alone.  Each attention's weights are rebuilt from
    its saved statistics, with D_i = dctx_i . ctx_i."""
    kv, sa_qkv, sa_ctx, sa_stats, t1, xh1, inv1, q, ctx, stats, t2, xh2, inv2, h1, xh3, inv3 = acts
    heads = layer.multihead_attn.heads
    ca = layer.multihead_attn
    w_q, w_k, w_v = ca.in_proj_weight.chunk(3)
    t1 = tgt if layer.self_attn is None else t1
    # LN3, the FFN and LN2
    dn3_g, dn3_b = _rows_sum(g * xh3), _rows_sum(g)
    dr3 = _layer_norm_bwd(g, xh3, inv3, layer.norm3.weight)
    db2, dw2 = _rows_sum(dr3), _wgrad(dr3, h1)
    dz1 = (dr3 @ layer.linear2.weight) * (h1 > 0)
    db1, dw1 = _rows_sum(dz1), _wgrad(dz1, t2)
    dt2 = dr3 + dz1 @ layer.linear1.weight
    dn2_g, dn2_b = _rows_sum(dt2 * xh2), _rows_sum(dt2)
    dr2 = _layer_norm_bwd(dt2, xh2, inv2, layer.norm2.weight)
    # the cross-attention and its projections
    dbo, dwo = _rows_sum(dr2), _wgrad(dr2, ctx)
    dq, dk, dv = _attention_bwd(q, *kv.chunk(2, dim=-1), dr2 @ ca.out_proj.weight, ctx, stats,
                                mask, heads)
    dw_in = torch.cat([_wgrad(dq, t1 + query_pos), _wgrad(dk, memory + pos), _wgrad(dv, memory)])
    db_in = torch.cat([_rows_sum(dq), _rows_sum(dk), _rows_sum(dv)])
    dpos = dk @ w_k
    dmem = dv @ w_v + dpos
    dqpos = dq @ w_q
    dt1 = dr2 + dqpos
    ca_grads = [dw_in, db_in, dwo, dbo, dn2_g, dn2_b, dw1, db1, dw2, db2, dn3_g, dn3_b]
    if layer.self_attn is None:
        return dt1, dmem, dpos, dqpos, ca_grads
    # LN1 and the self-attention
    sa = layer.self_attn
    dn1_g, dn1_b = _rows_sum(dt1 * xh1), _rows_sum(dt1)
    dr1 = _layer_norm_bwd(dt1, xh1, inv1, layer.norm1.weight)
    dbo_sa, dwo_sa = _rows_sum(dr1), _wgrad(dr1, sa_ctx)
    dsa = _attention_bwd(*sa_qkv.chunk(3, dim=-1), dr1 @ sa.out_proj.weight, sa_ctx, sa_stats,
                         None, heads)
    a = tgt + query_pos
    dw_sa = torch.cat([_wgrad(dsa[0], a), _wgrad(dsa[1], a), _wgrad(dsa[2], tgt)])
    db_sa = torch.cat([_rows_sum(t) for t in dsa])
    w_sq, w_sk, w_sv = sa.in_proj_weight.chunk(3)
    dtgt = dr1 + dsa[0] @ w_sq + dsa[1] @ w_sk + dsa[2] @ w_sv
    dqpos = dqpos + dsa[0] @ w_sq + dsa[1] @ w_sk
    return dtgt, dmem, dpos, dqpos, [dw_sa, db_sa, dwo_sa, dbo_sa, dn1_g, dn1_b, *ca_grads]


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
    size.argtypes = [ctypes.c_int] * 5
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
    fn.argtypes = [ctypes.c_void_p] * 49 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return size, fn


def _slots(tensors, self_attn: bool) -> list:
    """Pointers in the C functions' 18 weight slots: 0 for the
    self-attention's six without self-attention."""
    ptrs = [t.data_ptr() for t in tensors]
    return ptrs if self_attn else [0] * 6 + ptrs


def _saved_shapes(b: int, q: int, length: int, f: int, heads: int, self_attn: bool,
                  d: int = DIM) -> tuple:
    """The shapes of SAVED's tensors for tgt [b, q, d], memory [b, length, d]
    and FFN width f; None for the self-attention's six without
    self-attention."""
    widths = {"sa_qkv": 3 * d, "h1": f}
    shapes = []
    for name in SAVED:
        if name in _SELF_ATTN_SAVED and not self_attn:
            shapes.append(None)
        elif name == "kv":
            shapes.append((b, length, 2 * d))
        elif name.endswith("stats"):
            shapes.append((b, heads, q, 2))
        elif name.startswith("inv"):
            shapes.append((b, q))
        else:
            shapes.append((b, q, widths.get(name, d)))
    return tuple(shapes)


def _pointer_array(tensors):
    """A C array of the tensors' device pointers (SAVED's order, 0 for
    None), or None."""
    if tensors is None:
        return None
    return (ctypes.c_void_p * len(tensors))(*(0 if t is None else t.data_ptr() for t in tensors))


def _forward_kernel(tgt, memory, mask, pos, query_pos, layer, weights, self_attn, save: bool):
    """out, and with `save` the SAVED tensors the launch wrote (else None)."""
    (b, q, d), length, f = tgt.shape, memory.shape[1], weights[-6].shape[0]
    heads = layer.multihead_attn.heads
    out = torch.empty_like(tgt)
    acts = (tuple(None if shape is None else tgt.new_empty(shape)
                  for shape in _saved_shapes(b, q, length, f, heads, self_attn))
            if save else None)
    with torch.cuda.device(tgt.device):
        size, launch = _launcher(tgt.device.index)
        ws = tgt.new_empty(int(size(b, q, length, f, int(save))))
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        args = ([t.data_ptr() for t in (tgt, memory, mask, pos, query_pos)]
                + _slots(weights, self_attn) + [out.data_ptr(), _pointer_array(acts),
                                                ws.data_ptr()])
        err = launch(*args, b, q, length, d, heads, f, int(self_attn), stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder_layer: CUDA error {err} at launch")
    fused_decoder_layer.launches += 1
    return out, acts


def fused_decoder_layer_fwd(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                            pos: torch.Tensor, query_pos: torch.Tensor,
                            layer: DetrDecoderLayer):
    """The forward kernel's training variant, as autograd runs it: (out,
    the SAVED tensors its backward takes as `acts`; acts[0] is the memory's
    k|v [B, L, 2D], which it also takes alone as `kv`).  CUDA tensors only,
    contiguous (`fused_decoder_layer` is the layer's entry point);
    `decoder_layer_acts_reference` is its plain version."""
    if tgt.device.type != "cuda":
        raise ValueError("fused_decoder_layer_fwd: the kernel takes CUDA tensors; "
                         "on the CPU run decoder_layer_acts_reference")
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    return _forward_kernel(tgt, memory, mask, pos, query_pos, layer,
                           _weights(layer, tgt.device), layer.self_attn is not None, save=True)


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


def _check_acts(acts, tgt: torch.Tensor, memory: torch.Tensor, layer: DetrDecoderLayer,
                f: int) -> None:
    """A saved set the backward takes: SAVED's tensors of the forward on
    these shapes, float32 on tgt's device, contiguous and 16-byte aligned
    (None exactly where the layer has no self-attention)."""
    self_attn = layer.self_attn is not None
    want = _saved_shapes(*tgt.shape[:2], memory.shape[1], f, layer.multihead_attn.heads,
                         self_attn, tgt.shape[2])
    if len(acts) != len(SAVED):
        raise ValueError(f"fused_decoder_layer_bwd: acts holds {len(acts)} tensors, "
                         f"not the {len(SAVED)} of {SAVED}")
    for name, t, shape in zip(SAVED, acts, want):
        if (t is None) != (shape is None) or (t is not None and tuple(t.shape) != shape):
            got = None if t is None else tuple(t.shape)
            raise ValueError(f"fused_decoder_layer_bwd: acts {name} {got}, want {shape}")
    try:
        _check_tensors([t for t in acts if t is not None], tgt.device)
    except ValueError as err:
        raise ValueError(f"fused_decoder_layer_bwd: acts: {err}") from None


def fused_decoder_layer_bwd(tgt: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor,
                            pos: torch.Tensor, query_pos: torch.Tensor, g: torch.Tensor,
                            layer: DetrDecoderLayer, kv: Optional[torch.Tensor] = None,
                            acts=None):
    """Backward of the layer: (dtgt, dmemory, dpos, dquery_pos, gradients
    of the tensors of `_layer_tensors(layer)`, in that order), from `acts`
    (the SAVED tensors of `fused_decoder_layer_fwd` on the same inputs) or,
    without them, by recompute: of the query side alone when given `kv`,
    the forward's k|v of the same inputs, else of the whole forward.  The
    result is the same to the bit every way.  CUDA tensors only: the plain
    version of this kernel is autograd through
    `fused_decoder_layer_reference`, or `decoder_layer_bwd_from_acts_reference`."""
    if kv is not None and acts is not None:
        raise ValueError("fused_decoder_layer_bwd: give kv or acts (which holds it), not both")
    if kv is not None:
        _check_kv(kv, memory)
    if acts is not None:
        _check_acts(acts, tgt, memory, layer, layer.linear1.out_features)
    if tgt.device.type != "cuda":
        raise ValueError("fused_decoder_layer_bwd: the kernel takes CUDA tensors; "
                         "on the CPU differentiate fused_decoder_layer_reference")
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    _check_tensors((g,), tgt.device)
    if g.shape != tgt.shape:
        raise ValueError(f"fused_decoder_layer_bwd: g {tuple(g.shape)} vs tgt "
                         f"{tuple(tgt.shape)}")
    return _backward_kernel(tgt, memory, mask, pos, query_pos, g, layer,
                            _weights(layer, tgt.device), kv, acts)


def _backward_kernel(tgt, memory, mask, pos, query_pos, g, layer, weights, kv, acts):
    """The backward's launch on checked inputs (`fused_decoder_layer_bwd`)."""
    self_attn = layer.self_attn is not None
    (b, q, d), length, f = tgt.shape, memory.shape[1], weights[-6].shape[0]
    given = 2 if acts is not None else 1 if kv is not None else 0
    grads = [torch.empty_like(w) for w in weights]
    dtgt, dqpos = torch.empty_like(tgt), torch.empty_like(tgt)
    dmem, dpos = torch.empty_like(memory), torch.empty_like(memory)
    with torch.cuda.device(tgt.device):
        size, launch = _bwd_launcher(tgt.device.index)
        ws = tgt.new_empty(int(size(b, q, length, f, given)))
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        args = ([t.data_ptr() for t in (tgt, memory, mask, pos, query_pos, g)]
                + _slots(weights, self_attn)
                + [t.data_ptr() for t in (dtgt, dmem, dpos, dqpos)]
                + _slots(grads, self_attn)
                + [0 if kv is None else kv.data_ptr(), _pointer_array(acts), ws.data_ptr()])
        err = launch(*args, b, q, length, d, layer.multihead_attn.heads, f, int(self_attn),
                     stream)
    if err != 0:
        raise RuntimeError(f"fused_decoder_layer_bwd: CUDA error {err} at launch")
    fused_decoder_layer_bwd.launches += 1
    return dtgt, dmem, dpos, dqpos, grads


fused_decoder_layer_bwd.launches = 0


class _DecoderLayerFn(torch.autograd.Function):
    """Forward kernel, backward kernel.  With a gradient to take, the
    forward keeps what the backward reads (SAVED); without one it keeps
    nothing."""

    @staticmethod
    def forward(ctx, tgt, memory, mask, pos, query_pos, layer, train, *weights):
        ctx.layer, ctx.weights = layer, weights
        out, acts = _forward_kernel(tgt, memory, mask, pos, query_pos, layer, weights,
                                    layer.self_attn is not None, save=train)
        if train:
            ctx.save_for_backward(tgt, memory, mask, pos, query_pos, *acts)
        return out

    @staticmethod
    def backward(ctx, g):
        # the forward checked its inputs and wrote the saved set: only the
        # cotangent is new (launching from here spares the host the checks)
        tgt, memory, mask, pos, query_pos, *acts = ctx.saved_tensors
        g = g.contiguous()
        _check_tensors((g,), tgt.device)
        dtgt, dmem, dpos, dqpos, grads = _backward_kernel(
            tgt, memory, mask, pos, query_pos, g, ctx.layer, ctx.weights, None, acts)
        return (dtgt, dmem, None, dpos, dqpos, None, None, *grads)


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
    broadcast views).  The forward keeps its activations for the backward
    only where a gradient will be taken (grad mode on, and an input or a
    weight requiring one)."""
    _check_self_attn(layer, self_attn)
    if tgt.device.type == "cpu":
        return fused_decoder_layer_reference(tgt, memory, mask, pos, query_pos, layer)
    tgt, memory, mask, pos, query_pos = (t.contiguous() for t in (tgt, memory, mask, pos,
                                                                   query_pos))
    _check_inputs(tgt, memory, mask, pos, query_pos, layer)
    weights = _weights(layer, tgt.device)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (tgt, memory, pos, query_pos, *weights))
    return _DecoderLayerFn.apply(tgt, memory, mask, pos, query_pos, layer, train, *weights)


fused_decoder_layer.launches = 0
