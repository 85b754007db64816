"""The plain version of the DETR encoder layer's backward from the forward's
saved activations (ops/cuda/fused_encoder_layer.py:
`encoder_layer_acts_reference`, `encoder_layer_bwd_from_acts_reference`),
against `fused_encoder_layer_reference` on the CPU.

The backward kernel (#2) takes the training forward's SAVED tensors
instead of recomputing the forward; these tests show without a card that
the set is enough: the saved tensors are the plain layer's own
intermediates, and the hand-derived backward, reading x, the mask, g, the
weights, the Philox masks and that set alone, gives autograd's gradients
through the plain layer, at both precisions and at rates 0 and 0.1, a
batch row with no valid key included.  In float64 both hold to rounding
(1e-10: at "bf16" the operands are rounded to bf16 on both sides, and
float64 sums put none of them on the other side of a rounding boundary);
in float32 at "f32" the gradients hold to tests/test_torch_port_encoder_layer.py's
VJP_ATOL (2e-4 abs).  On the card, chip_smoke.py and
tests/test_torch_port_cuda.py hold the kernels against these functions and
against the recomputing backward.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel

D, HEADS, FFN = 64, 2, 128
VJP_ATOL = 2e-4
PRECISIONS = ("f32", "bf16")


def _layer(seed, dtype=torch.float64, d=D, heads=HEADS, ffn=FFN):
    gen = torch.Generator().manual_seed(seed)
    layer = DetrEncoderLayer(d, heads, ffn)
    layer.reset_parameters(gen)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return layer.to(dtype)


def _inputs(b, L, seed, dtype=torch.float64):
    """x, pos, g [b, L, D] and a ragged key mask whose last row keeps no key."""
    rng = np.random.default_rng(seed)
    x, pos, g = (torch.from_numpy(rng.standard_normal((b, L, D))).to(dtype) for _ in range(3))
    mask = torch.from_numpy((np.arange(L)[None] < rng.integers(1, L + 1, b)[:, None]) * 1.0)
    mask[-1] = 0.0
    return x, pos, g, mask.to(dtype)


def _layer_norm_stats(t):
    mean = t.mean(-1, keepdim=True)
    inv = torch.rsqrt((t - mean).pow(2).mean(-1, keepdim=True) + 1e-5)
    return (t - mean) * inv, inv[..., 0]


def _reference_intermediates(x, mask, pos, layer, rate, seed, precision, monkeypatch):
    """(out, {SAVED name: tensor}) as `fused_encoder_layer_reference` computes
    them: read from its modules' inputs (and, at "bf16", from its calls of
    `bf16_matmul`), q|k|v from the same calls, stats from its scores."""
    seen, calls, hooks = {}, [], []
    keep = lambda name, out=False: (lambda m, i, o: seen.update({name: o if out else i[0]}))
    hooks.append(layer.norm1.register_forward_hook(keep("r1")))
    hooks.append(layer.norm1.register_forward_hook(keep("y1", out=True)))
    hooks.append(layer.norm2.register_forward_hook(keep("r2")))
    sa = layer.self_attn
    if precision == "bf16":
        real = fel.bf16_matmul
        monkeypatch.setattr(fel, "bf16_matmul",
                            lambda a, b, scale=1.0: calls.append((a, real(a, b, scale)))
                            or calls[-1][1])
    else:
        hooks.append(sa.register_forward_pre_hook(
            lambda m, args, kw: seen.update(a=args[0], x=args[2], key_mask=kw["key_mask"]),
            with_kwargs=True))
        hooks.append(sa.out_proj.register_forward_pre_hook(
            lambda m, i: seen.update(ctx=i[0])))
        hooks.append(layer.linear2.register_forward_pre_hook(
            lambda m, i: seen.update(h1=i[0])))
    with torch.no_grad():
        out = fel.fused_encoder_layer_reference(x, mask, pos, layer, rate, seed, precision)
    for h in hooks:
        h.remove()
    bq, bk, bv = sa.in_proj_bias.chunk(3, dim=0)
    dh = D // HEADS
    if precision == "bf16":
        (a, q), (_, k), (_, v), (_, scores), _, (ctx, _), _, (h1, _) = calls
        qkv = torch.cat([q + bq, k + bk, v + bv], dim=-1)
    else:
        a, ctx, h1 = seen["a"], seen["ctx"], seen["h1"]
        assert seen["key_mask"] is mask
        wq, wk, wv = sa.in_proj_weight.chunk(3, dim=0)
        qkv = torch.cat([F.linear(a, wq, bq), F.linear(a, wk, bk), F.linear(seen["x"], wv, bv)],
                        dim=-1)
        heads = lambda t: t.reshape(*t.shape[:2], HEADS, dh).transpose(1, 2)
        q, k = (heads(t) for t in qkv.chunk(3, dim=-1)[:2])
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    scores = torch.where(mask[:, None, None, :] != 0, scores, torch.full_like(scores, -1e9))
    mx = scores.amax(-1)
    total = torch.exp(scores - mx[..., None]).sum(-1)
    xh1, inv1 = _layer_norm_stats(seen["r1"])
    xh2, inv2 = _layer_norm_stats(seen["r2"])
    acts = dict(a=a, qkv=qkv, ctx=ctx, y1=seen["y1"], h1=h1, xh1=xh1, inv1=inv1, xh2=xh2,
                inv2=inv2, stats=torch.stack([mx, total], dim=-1))
    return out, acts


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,L", [(3, 9), (4, 33)])
def test_saved_set_is_the_plain_layers_intermediates(b, L, rate, precision, monkeypatch):
    """In float64, the acts function's output and each SAVED tensor are the
    plain layer's own, to rounding (1e-10)."""
    layer = _layer(b + L)
    x, pos, _, mask = _inputs(b, L, seed=L)
    want_out, want = _reference_intermediates(x, mask, pos, layer, rate, 17, precision,
                                              monkeypatch)
    with torch.no_grad():
        out, acts = fel.encoder_layer_acts_reference(x, mask, pos, layer, rate, 17, precision)
    torch.testing.assert_close(out, want_out, atol=1e-10, rtol=0)
    assert len(acts) == len(fel.SAVED)
    for name, got in zip(fel.SAVED, acts):
        torch.testing.assert_close(got, want[name], atol=1e-10, rtol=0, msg=name)
    if rate > 0.0:                     # dropout really acted on the saved set
        _, plain = fel.encoder_layer_acts_reference(x, mask, pos, layer, 0.0, 17, precision)
        assert (plain[fel.SAVED.index("h1")] - acts[fel.SAVED.index("h1")]).abs().max() > 1e-3


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,L", [(2, 1), (3, 9), (4, 33)])
def test_backward_from_saved_set_is_autograd_through_the_plain_layer(b, L, rate, precision):
    """In float64, dx, dpos and every parameter's gradient from the saved set
    equal autograd's through `fused_encoder_layer_reference` to rounding
    (1e-10): a length-1 sequence and a row with no valid key included."""
    layer = _layer(3 * b + L)
    x, pos, g, mask = _inputs(b, L, seed=b * L)
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer_reference(xi, mask, pi, layer, rate, 5, precision)
    want = torch.autograd.grad(out, [xi, pi, *fel._layer_tensors(layer)], g)
    with torch.no_grad():
        out2, acts = fel.encoder_layer_acts_reference(x, mask, pos, layer, rate, 5, precision)
        dx, dpos, grads = fel.encoder_layer_bwd_from_acts_reference(x, mask, pos, g, layer, acts,
                                                                    rate, 5, precision)
    torch.testing.assert_close(out2, out.detach(), atol=1e-10, rtol=0)
    for got, ref in zip([dx, dpos, *grads], want):
        torch.testing.assert_close(got, ref, atol=1e-10, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_from_saved_set_in_float32(rate):
    """In float32 at the paper's widths (D=256, 8 heads, F=1024), the saved
    set's backward against autograd through the plain layer within VJP_ATOL,
    the tolerance of the layer's other gradient tests."""
    b, L = 2, 21
    layer = _layer(11, torch.float32, 256, 8, 1024)
    rng = np.random.default_rng(12)
    x, pos, g = (torch.from_numpy(rng.standard_normal((b, L, 256), dtype=np.float32))
                 for _ in range(3))
    mask = torch.from_numpy((np.arange(L)[None] < np.array([[L], [7]])) * np.float32(1))
    xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out = fel.fused_encoder_layer(xi, mask, pi, layer, rate, 23)
    want = torch.autograd.grad(out, [xi, pi, *fel._layer_tensors(layer)], g)
    with torch.no_grad():
        out2, acts = fel.encoder_layer_acts_reference(x, mask, pos, layer, rate, 23)
        got = fel.encoder_layer_bwd_from_acts_reference(x, mask, pos, g, layer, acts, rate, 23)
    torch.testing.assert_close(out2, out.detach(), atol=3e-5, rtol=0)
    for i, (a, c) in enumerate(zip([got[0], got[1], *got[2]], want)):
        torch.testing.assert_close(a, c, atol=VJP_ATOL, rtol=0, msg=f"gradient {i}")
    assert fel.fused_encoder_layer.launches == 0


def test_saved_set_names_shapes_and_order():
    """SAVED's order is the acts function's and the kernels' (EncoderSaved in
    csrc/layer_bwd_kernels.cuh); each tensor has the shape the wrapper
    allocates, 3,090 floats a row at the paper's widths."""
    b, L, heads, f = 2, 5, 8, 1024
    shapes = fel._saved_shapes(b, L, f, heads)
    assert fel.SAVED == ("a", "qkv", "ctx", "y1", "h1", "xh1", "inv1", "xh2", "inv2", "stats")
    assert sum(int(np.prod(s)) for s in shapes) == b * L * 3090
    layer = _layer(0, torch.float32, 256, heads, f)
    x = torch.randn(b, L, 256, generator=torch.Generator().manual_seed(1))
    _, acts = fel.encoder_layer_acts_reference(x, torch.ones(b, L), x, layer)
    assert tuple(tuple(a.shape) for a in acts) == shapes
    with open(fel.kernels.CSRC + "/layer_bwd_kernels.cuh") as src:
        text = src.read()
    enum = text[text.index("enum EncoderSaved"):]
    names = [n.strip().lower() for n in enum[enum.index("{") + 1:enum.index("}")].split(",")]
    assert [n.removeprefix("kencsaved") for n in names] == list(fel.SAVED)


def test_the_kernel_entry_points_refuse_cpu_tensors():
    """On the CPU only the plain versions run: the training forward's kernel
    entry and the backward given a saved set raise, counting no launch."""
    layer = _layer(1, torch.float32, 256, 8, 1024)
    x, mask = torch.zeros(1, 4, 256), torch.ones(1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fel.fused_encoder_layer_fwd(x, mask, x, layer)
    _, acts = fel.encoder_layer_acts_reference(x, mask, x, layer)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fel.fused_encoder_layer_bwd(x, mask, x, x, layer, acts=acts)
    with pytest.raises(ValueError, match="precision"):
        fel.encoder_layer_acts_reference(x, mask, x, layer, precision="tf32")
    assert fel.fused_encoder_layer.launches == fel.fused_encoder_layer_bwd.launches == 0
