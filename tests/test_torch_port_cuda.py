"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports nothing of JAX, so it runs on
the machine with the card, where JAX is absent:

    python3 -m pytest -m cuda tests/test_torch_port_cuda.py -q

Forward outputs agree to 1e-4 (float32 kernels with 3xTF32 GEMMs, outputs
of order 1 after LayerNorm); gradients to 1e-3 of each tensor's largest
magnitude.  The shapes are small enough that few ReLU gates sit within
rounding of zero; chip_smoke.py holds the kernels at the training shapes
against a float64 run.  The decoder layer's gradients are held as
chip_smoke.py holds them: against a float64 run of the plain version,
within 1e-3 of each tensor's largest magnitude plus twice the float32 plain
version's own error there, plus, element by element, the sum of what
flipping each FFN gate whose float64 pre-activation lies within 1e-5 of
zero does to the float64 run (at 3,000 query rows the kernel may flip such
a gate where the float32 plain run flips none).  The encoder layer at
precision "bf16" rounds every product's operands to bf16 on both sides,
and one float32 rounding step apart can put an operand (or a ReLU gate) on
the other side of a bf16 rounding boundary: its gradients are held against
the float64 run of the float32 layer, within 1e-2 of their largest
magnitude plus twice the bf16 plain version's own distance from it.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.eval.similarity import xpool_sim_fused, xpool_similarity_blocked
from mgsv_tpu_torch.models.detr import DetrDecoderLayer, DetrEncoderLayer
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import flash_attention as fa
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from mgsv_tpu_torch.models.temporal import TemporalLayer
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return resolve_device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


def _ragged(rng, rows, length, dev):
    lens = rng.integers(1, length + 1, rows)
    return torch.from_numpy((np.arange(length)[None] < lens[:, None]).astype(np.float32)).to(dev)


def _perturbed(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return module


def _assert_grads(got, want):
    for k, p in zip(got, want):
        torch.testing.assert_close(k, p, atol=1e-3 * p.abs().max().item() + 1e-6, rtol=0)


def _assert_grads_vs_float64(kernel, plain, exact, rel=1e-3, slack=None):
    for i, (k, p, e) in enumerate(zip(kernel, plain, exact)):
        plain_err = (p.double() - e).abs().max().item()
        diff = (k.double() - e).abs()
        beyond = (diff if slack is None else diff - slack[i]).max().item()
        assert beyond <= rel * e.abs().max().item() + 2 * plain_err + 1e-6, (i, beyond, plain_err)


def _gate_flip_slack(layer64, grads_of, eps=1e-5):
    """(float64 gradients, per tensor the sum over the FFN gates within eps
    of zero of |the same with that gate flipped - them|): see
    chip_smoke.py::gate_flip_slack."""
    seen = {}
    hook = layer64.linear1.register_forward_hook(lambda m, i, o: seen.update(z=o.detach()))
    exact = grads_of()
    hook.remove()
    near = torch.nonzero(seen["z"].abs() < eps)
    slack = [torch.zeros_like(e) for e in exact]
    for idx in near:                   # one gate at a time: their effects add
        flip = torch.zeros_like(seen["z"], dtype=torch.bool)
        flip[tuple(idx)] = True
        hook = layer64.linear1.register_forward_hook(
            lambda m, i, o: torch.where(flip, o - 2 * o.detach(), o))
        for s_, a, b in zip(slack, grads_of(), exact):
            s_ += (a - b).abs()
        hook.remove()
    return exact, slack


def _encoder_layer(dev):
    layer = DetrEncoderLayer(256, 8, 1024)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    return _perturbed(layer, 1).to(dev)


def test_cuda_kernel_matches_plain_version(dev):
    rng = np.random.default_rng(3)
    x, pos = _randn(rng, (8, 152, 256), dev), _randn(rng, (8, 152, 256), dev)
    mask = _ragged(rng, 8, 152, dev)
    layer = _encoder_layer(dev)
    before = fel.fused_encoder_layer.launches
    with torch.no_grad():
        out = fel.fused_encoder_layer(x, mask, pos, layer)
        ref = fel.fused_encoder_layer_reference(x, mask, pos, layer)
    assert fel.fused_encoder_layer.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,L", [(4, 152), (15, 150), (3, 21)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_backward_kernel_matches_plain_version(dev, rate, b, L):
    """B*L rows: one full split-K chunk, two with a ragged second (2,250
    rows), and fewer rows than one 64-row tile (63)."""
    rng = np.random.default_rng(4)
    x, pos, g = (_randn(rng, (b, L, 256), dev) for _ in range(3))
    mask = _ragged(rng, b, L, dev)
    layer = _encoder_layer(dev)
    before = fel.fused_encoder_layer_bwd.launches
    outs, grads = [], []
    for fn in (fel.fused_encoder_layer, fel.fused_encoder_layer_reference):
        xi, pi = x.clone().requires_grad_(), pos.clone().requires_grad_()
        out = fn(xi, mask, pi, layer, rate, 7)
        grads.append(torch.autograd.grad(out, [xi, pi, *layer.parameters()], g))
        outs.append(out.detach())
    assert fel.fused_encoder_layer_bwd.launches == before + 1
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)
    _assert_grads(*grads)


@pytest.mark.parametrize("vc,m,s", [(70, 9, 96), (128, 64, 96), (33, 5, 50)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_cuda_xpool_kernels_match_plain_version(dev, vc, m, s, rate):
    """Ragged V and M (70 videos: a partial 128-video tile), full tiles, and
    a snippet count that is no multiple of 16."""
    rng = np.random.default_rng(vc + m)
    weights = [w.detach() for w in _perturbed(XPoolTransformer(256), 2).to(dev).stage_weights()]
    q = _randn(rng, (vc, 256), dev)
    vhat = torch.nn.functional.normalize(_randn(rng, (vc, 256), dev), dim=-1)
    k, v = _randn(rng, (m, s, 256), dev), _randn(rng, (m, s, 256), dev)
    mask, g = _ragged(rng, m, s, dev), _randn(rng, (m, vc), dev)
    before = xps.xpool_sim_fwd.launches, xps.xpool_sim_bwd.launches
    outs, grads = [], []
    for fn in (xps.xpool_sim, xps.xpool_sim_reference):
        ins = [t.clone().requires_grad_() for t in (q, k, v, vhat, *weights)]
        out = fn(ins[0], ins[1], ins[2], mask, ins[3], ins[4:], rate, 9)
        grads.append(torch.autograd.grad(out, ins, g))
        outs.append(out.detach())
    assert (xps.xpool_sim_fwd.launches, xps.xpool_sim_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)
    _assert_grads(*grads)


def _xpool_inputs(dev, vc, m, s, seed):
    """Stage weights off identity, q, vhat, k, v and ragged snippet masks
    with one track (the middle one) whose every snippet is masked."""
    rng = np.random.default_rng(seed)
    weights = [w.detach() for w in _perturbed(XPoolTransformer(256), seed).to(dev).stage_weights()]
    q = _randn(rng, (vc, 256), dev)
    vhat = torch.nn.functional.normalize(_randn(rng, (vc, 256), dev), dim=-1)
    k, v = _randn(rng, (m, s, 256), dev), _randn(rng, (m, s, 256), dev)
    mask = _ragged(rng, m, s, dev)
    mask[m // 2] = 0
    return q, k, v, mask, vhat, weights


@pytest.mark.parametrize("vc,m,s", [(1, 5, 96), (200, 3, 37), (130, 3, 256), (64, 4, 96),
                                    (33, 4, 5), (5, 300, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_cuda_xpool_forward_shapes(dev, vc, m, s, rate):
    """The forward kernel alone: one video, a partial 128-video tile (200
    videos), three tracks, S = 37, S = 5 (fewer snippets than one 16-deep
    slice) and S = MAX_S (two score chunks), 300 tracks at S = MAX_S (two
    groups of the workspace: the second group's dropout stream starts at its
    first track), a track with no valid snippet; within 1e-4 of the plain
    version, one launch per call, and two calls give the same bits."""
    q, k, v, mask, vhat, weights = _xpool_inputs(dev, vc, m, s, vc + s)
    before = xps.xpool_sim_fwd.launches
    first = xps.xpool_sim_fwd(q, k, v, mask, vhat, weights, rate, 9)
    assert xps.xpool_sim_fwd.launches == before + 1
    second = xps.xpool_sim_fwd(q, k, v, mask, vhat, weights, rate, 9)
    want = xps.xpool_sim_reference(q, k, v, mask, vhat, weights, rate, 9)
    assert first.shape == (m, vc)
    torch.testing.assert_close(first, want, atol=1e-4, rtol=0)
    assert torch.equal(first, second)


@pytest.mark.parametrize("vc,m,s", [(1, 3, 96), (200, 3, 37), (70, 5, 256)])
def test_cuda_eval_kernel_shapes(dev, vc, m, s):
    """`xpool_sim_eval` at the forward's edge shapes, a dead track included:
    within 1e-4 of its plain version, one launch per call, two calls the
    same bits."""
    q, k, v, mask, vhat, weights = _xpool_inputs(dev, vc, m, s, 2 * vc + s)
    before = xps.xpool_sim_eval.launches
    first = xps.xpool_sim_eval(q, k, v, mask, vhat, weights)
    assert xps.xpool_sim_eval.launches == before + 1
    second = xps.xpool_sim_eval(q, k, v, mask, vhat, weights)
    torch.testing.assert_close(first, xps.xpool_sim_eval_reference(q, k, v, mask, vhat, weights),
                               atol=1e-4, rtol=0)
    assert torch.equal(first, second)


@pytest.mark.parametrize("vc,m,s", [(70, 9, 96), (33, 5, 50), (64, 40, 96)])
def test_cuda_eval_kernel_matches_plain_version(dev, vc, m, s):
    """Kernel #4 (`xpool_sim_fused` through `xpool_sim_eval`) against the
    blocked plain path, with ragged snippet masks and a partial 128-video
    tile; one launch per call."""
    rng = np.random.default_rng(vc * m)
    xpool = _perturbed(XPoolTransformer(256), 3).to(dev)
    video = _randn(rng, (vc, 256), dev)
    segs, mask = _randn(rng, (m, s, 256), dev), _ragged(rng, m, s, dev)
    before = xps.xpool_sim_eval.launches
    with torch.no_grad():
        got = xpool_sim_fused(video, segs, mask, xpool)
        want = xpool_similarity_blocked(xpool, video, segs, mask, block_size=8)
    assert xps.xpool_sim_eval.launches == before + 1
    assert got.shape == (vc, m)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_cuda_eval_kernel_splits_the_tracks(dev, monkeypatch):
    """More tracks than one launch takes: the wrapper launches once per
    M_CHUNK tracks (here 16, for 40 tracks: 3 launches) and the parts line
    up with one launch over all of them."""
    rng = np.random.default_rng(5)
    weights = [w.detach() for w in _perturbed(XPoolTransformer(256), 4).to(dev).stage_weights()]
    q = _randn(rng, (50, 256), dev)
    vhat = torch.nn.functional.normalize(_randn(rng, (50, 256), dev), dim=-1)
    k, v = _randn(rng, (40, 96, 256), dev), _randn(rng, (40, 96, 256), dev)
    mask = _ragged(rng, 40, 96, dev)
    whole = xps.xpool_sim_eval(q, k, v, mask, vhat, weights)
    monkeypatch.setattr(xps, "M_CHUNK", 16)
    before = xps.xpool_sim_eval.launches
    parts = xps.xpool_sim_eval(q, k, v, mask, vhat, weights)
    assert xps.xpool_sim_eval.launches == before + 3
    torch.testing.assert_close(parts, whole, atol=0, rtol=0)
    torch.testing.assert_close(whole, xps.xpool_sim_eval_reference(q, k, v, mask, vhat, weights),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,lq,lk,masked", [(2, 3, 130, 200, True), (3, 2, 64, 64, False),
                                              (2, 12, 1214, 1214, False), (5, 4, 50, 50, True),
                                              (1, 2, 7, 300, True), (2, 2, 100, 129, False),
                                              (2, 3, 70, 1, True), (3, 2, 1, 300, True),
                                              (2, 2, 129, 1214, True)])
def test_cuda_flash_attention_matches_plain_version(dev, dtype, atol, b, h, lq, lk, masked):
    """Kernel #7 against its plain version: ragged key masks with a fully
    masked batch row (output 0), Lq != Lk, Lq = 1, lengths off the 64- and
    128-key tiles and the 128-row query tiles (Lk = 1, 129, 1214), and q, k,
    v as strided views of one packed [B, L, 3, H, 64] tensor, as the towers
    hand them over.  float32 1e-4 (3xTF32 products), bf16 2e-2."""
    rng = np.random.default_rng(b * lq + lk)
    qkv = _randn(rng, (b, max(lq, lk), 3, h, 64), dev).to(dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0][:, :, :lq], qkv[1][:, :, :lk], qkv[2][:, :, :lk]
    mask = None
    if masked:
        mask = _ragged(rng, b, lk, dev)
        mask[-1] = 0.0
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, 0.125, mask)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, 0.125, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, lq, 64)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if masked:
        assert not got[-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_is_bit_reproducible(dev, dtype):
    """Two calls on contiguous [B, H, L, 64] tensors give the same bits (each
    output row has one owner and a fixed order of sums)."""
    rng = np.random.default_rng(11)
    q, k, v = (_randn(rng, (3, 4, 300, 64), dev).to(dtype) for _ in range(3))
    mask = _ragged(rng, 3, 300, dev)
    first = fa.flash_attention(q, k, v, 0.125, mask)
    second = fa.flash_attention(q, k, v, 0.125, mask)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(),
                               fa.flash_attention_reference(q, k, v, 0.125, mask).float(),
                               atol=1e-4 if dtype == torch.float32 else 2e-2, rtol=0)


def test_cuda_flash_attention_refuses_other_head_dims(dev):
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, 0.125)


def _temporal_layer(dev):
    layer = TemporalLayer(256, 8, 1024, 0.0)
    gen = torch.Generator().manual_seed(5)
    for lin in (layer[3][0], layer[3][3]):
        torch.nn.init.normal_(lin.weight, 0.0, 256 ** -0.5, generator=gen)
    layer[1].reset_parameters(gen)
    return _perturbed(layer, 6).to(dev)


@pytest.mark.parametrize("b,L", [(4, 96), (12, 50), (3, 21), (2, 300), (40, 96), (40, 50),
                                 (4, 97), (12, 51)])
@pytest.mark.parametrize("rate", [0.0, 0.8])
def test_cuda_temporal_kernels_match_plain_version(dev, rate, b, L):
    """The temporal layer's forward and backward kernels (#5) against
    autograd through the plain version: the towers' L = 96 and 50 (B*L of
    384 and 600 rows, the second a ragged last 128-row tile), fewer rows
    than one tile, the longest L, the evaluation's B=40 at both towers' L,
    and the cls token's L = 97 and 51 (a last attention chunk of one row at
    97); ragged key masks with a row that keeps no key."""
    rng = np.random.default_rng(b * L)
    x, g = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    mask[-1] = 0.0
    layer = _temporal_layer(dev)
    before = ftl.fused_temporal_layer.launches, ftl.fused_temporal_layer_bwd.launches
    outs, grads = [], []
    for fn in (ftl.fused_temporal_layer, ftl.fused_temporal_layer_reference):
        xi = x.clone().requires_grad_()
        out = fn(xi, mask, layer, rate, 7)
        grads.append(torch.autograd.grad(out, [xi, *layer.parameters()], g))
        outs.append(out.detach())
    assert (ftl.fused_temporal_layer.launches, ftl.fused_temporal_layer_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)
    _assert_grads(*grads)


def test_cuda_temporal_kernels_as_one_shared_stack(dev):
    """#5 as transformer_is_share runs it: one layer's weights on the audio
    tower's rows and then the video tower's, each call with its own seed
    and its own saved activations; the weights' gradients, which autograd
    sums over both calls, and both inputs' against the plain version."""
    rng = np.random.default_rng(11)
    layer = _temporal_layer(dev)
    xs = [_randn(rng, (6, n, 256), dev) for n in (96, 50)]
    gs = [_randn(rng, (6, n, 256), dev) for n in (96, 50)]
    masks = [_ragged(rng, 6, n, dev) for n in (96, 50)]
    before = ftl.fused_temporal_layer.launches, ftl.fused_temporal_layer_bwd.launches
    outs, grads = [], []
    for fn in (ftl.fused_temporal_layer, ftl.fused_temporal_layer_reference):
        ins = [x.clone().requires_grad_() for x in xs]
        o = [fn(x, m, layer, 0.8, seed) for x, m, seed in zip(ins, masks, (7, 8))]
        grads.append(torch.autograd.grad(o, [*ins, *layer.parameters()], gs))
        outs.append([t.detach() for t in o])
    assert (ftl.fused_temporal_layer.launches, ftl.fused_temporal_layer_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    _assert_grads(*grads)


def test_cuda_temporal_backward_is_bit_reproducible(dev):
    """Two identical backward launches give bit-identical gradients (the
    weight gradients are summed in a fixed order, no atomics)."""
    rng = np.random.default_rng(8)
    x, g = _randn(rng, (40, 96, 256), dev), _randn(rng, (40, 96, 256), dev)
    mask = _ragged(rng, 40, 96, dev)
    layer = _temporal_layer(dev)
    first = ftl.fused_temporal_layer_bwd(x, mask, g, layer, 0.8, 3)
    second = ftl.fused_temporal_layer_bwd(x, mask, g, layer, 0.8, 3)
    for a, b in zip([first[0], *first[1]], [second[0], *second[1]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,L", [(4, 96), (12, 50), (3, 21), (2, 300), (40, 96), (40, 50),
                                 (4, 97), (12, 51)])
@pytest.mark.parametrize("rate", [0.0, 0.8])
def test_cuda_temporal_backward_from_saved_acts_equals_recompute(dev, rate, b, L):
    """The training forward's saved activations (#5) against their plain
    version, and the backward given them (what autograd runs) equal to the
    recomputing backward bit for bit: both run one forward sequence.  The
    same shapes as test_cuda_temporal_kernels_match_plain_version, a row
    that keeps no key included."""
    rng = np.random.default_rng(b * L + 1)
    x, g = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    mask[-1] = 0.0
    layer = _temporal_layer(dev)
    with torch.no_grad():
        out, acts = ftl.fused_temporal_layer_fwd(x, mask, layer, rate, 7)
        want_out, want = ftl.temporal_layer_acts_reference(x, mask, layer, rate, 7)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=0)
    for name, got, ref in zip(ftl.SAVED, acts, want):
        torch.testing.assert_close(got, ref, atol=1e-4 * max(1.0, ref.abs().max().item()),
                                   rtol=0, msg=name)
    before = ftl.fused_temporal_layer_bwd.launches
    saved = ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, 7, acts=acts)
    recomputed = ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, 7)
    assert ftl.fused_temporal_layer_bwd.launches == before + 2
    for a, c in zip([saved[0], *saved[1]], [recomputed[0], *recomputed[1]]):
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="acts"):
        ftl.fused_temporal_layer_bwd(x, mask, g, layer, rate, 7, acts=acts[:-1])


@pytest.mark.parametrize("L", [96, 50])
def test_cuda_temporal_forward_saves_only_for_a_gradient(dev, L):
    """Under torch.no_grad() (the evaluation's B=40) the forward allocates
    its output alone and keeps nothing; with a gradient to take it keeps
    the SAVED set for the backward."""
    rng = np.random.default_rng(L)
    x, mask = _randn(rng, (40, L, 256), dev), _ragged(rng, 40, L, dev)
    layer = _temporal_layer(dev)
    with torch.no_grad():
        ftl.fused_temporal_layer(x, mask, layer)         # first use: libraries, workspace
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated(dev)
        plain = torch.empty_like(x)
        one_output = torch.cuda.memory_allocated(dev) - start
        del plain
        start = torch.cuda.memory_allocated(dev)
        out = ftl.fused_temporal_layer(x, mask, layer)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) - start == one_output
        assert out.grad_fn is None
        del out
    start = torch.cuda.memory_allocated(dev)
    out = ftl.fused_temporal_layer(x, mask, layer, 0.8, 3)
    saved = sum(4 * int(np.prod(s)) for s in ftl._saved_shapes(40, L, 1024, 8))
    assert torch.cuda.memory_allocated(dev) - start >= one_output + saved
    del out
    assert torch.cuda.memory_allocated(dev) == start


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_encoder_bf16_matches_plain_version(dev, rate):
    """Kernels #1 and #2 at precision "bf16" against the bf16 plain version
    (operands rounded to bf16, float32 sums), and nearer it than the
    float32 kernel is."""
    rng = np.random.default_rng(5)
    x, pos, g = (_randn(rng, (6, 152, 256), dev) for _ in range(3))
    mask = _ragged(rng, 6, 152, dev)
    layer = _encoder_layer(dev)
    layer64 = copy.deepcopy(layer).double()
    before = fel.fused_encoder_layer.launches, fel.fused_encoder_layer_bwd.launches
    outs, grads = [], []
    for fn, lay, dt, prec in ((fel.fused_encoder_layer, layer, torch.float32, "bf16"),
                              (fel.fused_encoder_layer_reference, layer, torch.float32, "bf16"),
                              (fel.fused_encoder_layer_reference, layer64, torch.float64, "f32")):
        xi, pi = (t.to(dt).requires_grad_() for t in (x, pos))
        out = fn(xi, mask.to(dt), pi, lay, rate, 7, prec)
        grads.append(torch.autograd.grad(out, [xi, pi, *lay.parameters()], g.to(dt)))
        outs.append(out.detach())
    assert (fel.fused_encoder_layer.launches, fel.fused_encoder_layer_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        f32 = fel.fused_encoder_layer(x, mask, pos, layer, rate, 7)
    err = (outs[0] - outs[1]).abs().max().item()
    assert err <= 2e-2, err
    assert err < (f32 - outs[1]).abs().max().item()
    _assert_grads_vs_float64(*grads, rel=1e-2)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,L", [(5, 1), (3, 21), (7, 150), (2, 256), (8, 152), (6, 96)])
def test_cuda_encoder_forward_shapes(dev, precision, rate, b, L):
    """Kernel #1 against its plain version at L = 1, 21, 150, 256 and the 8
    serving rows (B=8, L=152), B*L off the GEMM core's 128-row tiles: float32
    within 1e-4; "bf16" within 2e-2 of the bf16 plain version and nearer it
    than the float32 kernel is."""
    rng = np.random.default_rng(100 * b + L)
    x, pos = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    layer = _encoder_layer(dev)
    before = fel.fused_encoder_layer.launches
    with torch.no_grad():
        out = fel.fused_encoder_layer(x, mask, pos, layer, rate, 9, precision)
        ref = fel.fused_encoder_layer_reference(x, mask, pos, layer, rate, 9, precision)
        f32 = fel.fused_encoder_layer(x, mask, pos, layer, rate, 9)
    assert fel.fused_encoder_layer.launches == before + 2
    assert out.shape == x.shape and torch.isfinite(out).all()
    if precision == "f32":
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        err = (out - ref).abs().max().item()
        assert err <= 2e-2 and err < (f32 - ref).abs().max().item(), err


def _decoder_layer(dev, self_attn):
    layer = DetrDecoderLayer(256, 8, 1024, self_attn=self_attn)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    return _perturbed(layer, 2).to(dev)


@pytest.mark.parametrize("b,q,L,self_attn", [(4, 1, 152, True), (6, 10, 152, True),
                                             (3, 3, 21, False), (300, 10, 8, True),
                                             (3, 1, 21, False), (3, 10, 21, False),
                                             (300, 1, 8, True), (40, 1, 152, True)])
def test_cuda_decoder_kernels_match_plain_version(dev, b, q, L, self_attn):
    """Kernel #6, forward and backward (given the forward's k|v, as autograd
    runs it): Q=1 and Q=10 at L=152 with ragged key masks (a row with one
    valid key), no self-attention, 2,400 memory rows (two split-K chunks)
    at a short L, and the evaluation's B=40 at Q=1.  Two recomputing
    backward calls are bit-identical."""
    rng = np.random.default_rng(b * q + L)
    tgt, qpos, g = (_randn(rng, (b, q, 256), dev) for _ in range(3))
    mem, pos = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    mask[0] = 0.0
    mask[0, 0] = 1.0
    layer = _decoder_layer(dev, self_attn)
    layer64 = copy.deepcopy(layer).double()
    before = fdl.fused_decoder_layer.launches, fdl.fused_decoder_layer_bwd.launches
    def run(fn, lay, dt):
        ins = [t.to(dt).requires_grad_() for t in (tgt, mem, pos, qpos)]
        out = fn(ins[0], ins[1], mask.to(dt), ins[2], ins[3], lay)
        return out.detach(), torch.autograd.grad(out, [*ins, *lay.parameters()], g.to(dt))

    out_k, grads_k = run(fdl.fused_decoder_layer, layer, torch.float32)
    out_p, grads_p = run(fdl.fused_decoder_layer_reference, layer, torch.float32)
    exact, slack = _gate_flip_slack(
        layer64, lambda: run(fdl.fused_decoder_layer_reference, layer64, torch.float64)[1])
    assert (fdl.fused_decoder_layer.launches, fdl.fused_decoder_layer_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out_k, out_p, atol=1e-4, rtol=0)
    _assert_grads_vs_float64(grads_k, grads_p, exact, slack=slack)
    again = fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer)
    first = fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer)
    for a, c in zip([*again[:4], *again[4]], [*first[:4], *first[4]]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,L,rate", [(40, 96, 0.0), (13, 50, 0.8)])
def test_cuda_temporal_forward_is_bit_reproducible(dev, b, L, rate):
    """Two identical calls of #5's forward give the same output to the bit
    (every product is owned by one tile, no atomics)."""
    rng = np.random.default_rng(b + L)
    x, mask = _randn(rng, (b, L, 256), dev), _ragged(rng, b, L, dev)
    layer = _temporal_layer(dev)
    with torch.no_grad():
        first = ftl.fused_temporal_layer(x, mask, layer, rate, 4)
        second = ftl.fused_temporal_layer(x, mask, layer, rate, 4)
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,q,L,self_attn", [(40, 1, 152, True), (5, 10, 152, True),
                                             (3, 3, 21, False)])
def test_cuda_decoder_forward_is_bit_reproducible(dev, b, q, L, self_attn):
    """Two identical calls of #6's training forward give the same output and
    the same saved set (the memory k|v first) to the bit, and the
    evaluation forward the same output."""
    rng = np.random.default_rng(b * q + L)
    tgt, qpos = _randn(rng, (b, q, 256), dev), _randn(rng, (b, q, 256), dev)
    mem, pos = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    layer = _decoder_layer(dev, self_attn)
    first = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)
    second = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)
    with torch.no_grad():
        out = fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos, layer)
    assert torch.equal(first[0], second[0])
    assert all((a is None and c is None) or torch.equal(a, c)
               for a, c in zip(first[1], second[1]))
    assert torch.equal(out, first[0])


@pytest.mark.parametrize("b,q,L,self_attn", [(6, 10, 152, True), (40, 1, 152, True),
                                             (3, 3, 21, False)])
def test_cuda_decoder_backward_takes_the_forward_kv(dev, b, q, L, self_attn):
    """#6's backward given the forward's memory k|v equals the recomputing
    backward to the bit (the same launches wrote it), and refuses a k|v of
    another shape or dtype."""
    rng = np.random.default_rng(3 * b + q + L)
    tgt, qpos, g = (_randn(rng, (b, q, 256), dev) for _ in range(3))
    mem, pos = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    layer = _decoder_layer(dev, self_attn)
    kv = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)[1][0]
    assert kv.shape == (b, L, 512)
    saved = fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, kv=kv)
    recomputed = fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer)
    for a, c in zip([*saved[:4], *saved[4]], [*recomputed[:4], *recomputed[4]]):
        assert torch.equal(a, c)
    for bad in (kv[:, :-1].contiguous(), kv.double()):
        with pytest.raises(ValueError, match="kv"):
            fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, kv=bad)


# (B, Q, L, self-attention): Q = 1, Q > L, L = Q = 256 (the attention
# backward's shared memory at its largest), odd B, one memory row
_DECODER_SAVED_SHAPES = [(6, 10, 152, True), (40, 1, 152, True), (7, 30, 21, True),
                         (3, 256, 256, True), (5, 3, 1, False), (9, 1, 37, False),
                         (2, 256, 256, False)]


def _decoder_inputs(dev, b, q, L, seed):
    """tgt, mem, mask, pos, qpos, g; row 0 of the mask keeps one key and
    the last row none (uniform weights)."""
    rng = np.random.default_rng(seed)
    tgt, qpos, g = (_randn(rng, (b, q, 256), dev) for _ in range(3))
    mem, pos = _randn(rng, (b, L, 256), dev), _randn(rng, (b, L, 256), dev)
    mask = _ragged(rng, b, L, dev)
    mask[0] = 0.0
    mask[0, min(3, L - 1)] = 1.0
    if b > 1:
        mask[-1] = 0.0
    return tgt, mem, mask, pos, qpos, g


@pytest.mark.parametrize("b,q,L,self_attn", _DECODER_SAVED_SHAPES)
def test_cuda_decoder_backward_from_saved_set_equals_recompute(dev, b, q, L, self_attn):
    """#6's training forward's saved set against its float64 plain version
    (`decoder_layer_acts_reference`), and the backward given it (what
    autograd runs) equal to the backward given the forward's k|v alone and
    to the wholly recomputing one, bit for bit: all three run one forward
    sequence.  A saved set that is not the forward's is refused."""
    tgt, mem, mask, pos, qpos, g = _decoder_inputs(dev, b, q, L, b * q + L)
    layer = _decoder_layer(dev, self_attn)
    layer64 = copy.deepcopy(layer).double()
    with torch.no_grad():
        out, acts = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)
        want_out, want = fdl.decoder_layer_acts_reference(
            *(t.double() for t in (tgt, mem, mask, pos, qpos)), layer64)
    torch.testing.assert_close(out.double(), want_out, atol=1e-4, rtol=0)
    for name, got, ref in zip(fdl.SAVED, acts, want):
        assert (got is None) == (ref is None), name
        if got is not None:
            torch.testing.assert_close(got.double(), ref,
                                       atol=1e-4 * max(1.0, ref.abs().max().item()), rtol=0,
                                       msg=name)
    before = fdl.fused_decoder_layer_bwd.launches
    runs = [fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, **kw)
            for kw in ({"acts": acts}, {"kv": acts[0]}, {})]
    assert fdl.fused_decoder_layer_bwd.launches == before + 3
    flat = [[*r[:4], *r[4]] for r in runs]
    for other in flat[1:]:
        for a, c in zip(flat[0], other):
            assert torch.equal(a, c)
    bad = list(acts)
    bad[7] = acts[7][:, :-1].contiguous() if q > 1 else acts[7].double()
    with pytest.raises(ValueError, match="acts"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, acts=bad)


@pytest.mark.parametrize("b,q,L,self_attn", _DECODER_SAVED_SHAPES)
def test_cuda_decoder_backward_from_saved_set_against_float64(dev, b, q, L, self_attn):
    """The backward given the saved set against a float64 autograd run of
    the plain layer, as test_cuda_decoder_kernels_match_plain_version holds
    it (the gate-flip slack included), at the shapes above: D_i from
    dctx . ctx on the rows with one valid key and with none."""
    tgt, mem, mask, pos, qpos, g = _decoder_inputs(dev, b, q, L, 7 * b + q + L)
    layer = _decoder_layer(dev, self_attn)
    layer64 = copy.deepcopy(layer).double()

    def run(lay, dt):
        ins = [t.to(dt).requires_grad_() for t in (tgt, mem, pos, qpos)]
        out = fdl.fused_decoder_layer_reference(ins[0], ins[1], mask.to(dt), ins[2], ins[3], lay)
        return torch.autograd.grad(out, [*ins, *fdl._layer_tensors(lay)], g.to(dt))

    with torch.no_grad():
        acts = fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)[1]
    got = fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, g, layer, acts=acts)
    exact, slack = _gate_flip_slack(layer64, lambda: run(layer64, torch.float64))
    _assert_grads_vs_float64([*got[:4], *got[4]], run(layer, torch.float32), exact, slack=slack)


@pytest.mark.parametrize("self_attn", [True, False])
def test_cuda_decoder_forward_saves_only_for_a_gradient(dev, self_attn):
    """Under torch.no_grad() (the evaluation's B=40) the forward allocates
    its output alone and keeps nothing; with a gradient to take it keeps
    the SAVED set for the backward, and frees it with the graph."""
    b, q, L = 40, 1, 152
    tgt, mem, mask, pos, qpos, _ = _decoder_inputs(dev, b, q, L, 11)
    layer = _decoder_layer(dev, self_attn)
    with torch.no_grad():
        fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos, layer)     # first use
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated(dev)
        plain = torch.empty_like(tgt)
        one_output = torch.cuda.memory_allocated(dev) - start
        del plain
        start = torch.cuda.memory_allocated(dev)
        out = fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos, layer)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) - start == one_output
        assert out.grad_fn is None
        del out
    start = torch.cuda.memory_allocated(dev)
    out = fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos.clone().requires_grad_(), layer)
    saved = sum(4 * int(np.prod(s)) for s in fdl._saved_shapes(b, q, L, 1024, 8, self_attn)
                if s is not None)
    assert torch.cuda.memory_allocated(dev) - start >= one_output + saved
    del out
    assert torch.cuda.memory_allocated(dev) == start


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("b,L", [(3, 152), (3, 21), (3, 256), (512, 152), (7, 96)])
def test_cuda_encoder_backward_against_float64(dev, precision, b, L):
    """Kernel #2 (its products on the wgmma core, its attention on the
    tensor cores) at row counts that are no multiple of the 128-row tile
    (456, 63, 768, 77,824 and 672 rows; L = 256 is the layer's longest, L =
    96 the CA fusion's), rate
    0.1 and a batch row with no valid key: every gradient against the
    float64 run of the plain version, within 1e-3 of its largest magnitude
    plus twice the float32 plain version's own error ("bf16": 1e-2, and the
    bf16 plain version's error, as in test_cuda_encoder_bf16_matches_plain_
    version); below 1,000 rows also with the gate-flip slack.  Two calls are
    bit-identical."""
    rng = np.random.default_rng(b + L)
    x, pos, g = (_randn(rng, (b, L, 256), dev) for _ in range(3))
    mask = _ragged(rng, b, L, dev)
    mask[1] = 0.0
    layer = _encoder_layer(dev)
    layer64 = copy.deepcopy(layer).double()

    def grads_of(fn, lay, dt, prec):
        xi, pi = (t.to(dt).requires_grad_() for t in (x, pos))
        out = fn(xi, mask.to(dt), pi, lay, 0.1, 7, prec)
        return torch.autograd.grad(out, [xi, pi, *lay.parameters()], g.to(dt))

    kernel = grads_of(fel.fused_encoder_layer, layer, torch.float32, precision)
    plain = grads_of(fel.fused_encoder_layer_reference, layer, torch.float32, precision)
    exact_of = lambda: grads_of(fel.fused_encoder_layer_reference, layer64, torch.float64, "f32")
    slack = None
    if precision == "f32" and b * L < 1000:
        exact, slack = _gate_flip_slack(layer64, exact_of)
    else:
        exact = exact_of()
    _assert_grads_vs_float64(kernel, plain, exact, rel=1e-3 if precision == "f32" else 1e-2,
                             slack=slack)
    first = fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, 0.1, 7, precision)
    second = fel.fused_encoder_layer_bwd(x, mask, pos, g, layer, 0.1, 7, precision)
    for a, c in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.isfinite(a).all() and torch.equal(a, c)


@pytest.mark.parametrize("vc,m,s", [(200, 37, 96), (300, 400, 37)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_xpool_backward_against_float64(dev, vc, m, s, rate):
    """Kernel #3's backward (Wout once per track, the pairs a chunk of
    musics at a time): V no multiple of 64, S = 96 and 37, 120,000 pairs
    (two music chunks), a track with no valid snippet; every gradient
    against the float64 run of the plain version, within 1e-3 of its
    largest magnitude plus twice the float32 plain version's own error.
    Two calls are bit-identical."""
    rng = np.random.default_rng(vc + m + s)
    weights = [w.detach() for w in _perturbed(XPoolTransformer(256), 2).to(dev).stage_weights()]
    q = _randn(rng, (vc, 256), dev)
    vhat = torch.nn.functional.normalize(_randn(rng, (vc, 256), dev), dim=-1)
    k, v = _randn(rng, (m, s, 256), dev), _randn(rng, (m, s, 256), dev)
    mask, g = _ragged(rng, m, s, dev), _randn(rng, (m, vc), dev)
    mask[1] = 0.0
    grads = []
    for fn, dt in ((xps.xpool_sim, torch.float32), (xps.xpool_sim_reference, torch.float32),
                   (xps.xpool_sim_reference, torch.float64)):
        ins = [t.to(dt).requires_grad_() for t in (q, k, v, vhat, *weights)]
        out = fn(ins[0], ins[1], ins[2], mask.to(dt), ins[3], ins[4:], rate, 9)
        grads.append(torch.autograd.grad(out, ins, g.to(dt)))
    _assert_grads_vs_float64(*grads)
    first = xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate, 9)
    second = xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, g, rate, 9)
    for a, c in zip([*first[:4], *first[4]], [*second[:4], *second[4]]):
        assert torch.isfinite(a).all() and torch.equal(a, c)


def test_cuda_two_ranks_over_nccl_equal_one_process(dev, tmp_path):
    """tests/test_torch_port_dist.py's (a) over NCCL, one card a rank: one
    float32 step of Config()'s widths at every dropout rate 0 on 2 ranks
    (8 rows each, music codes repeating across the ranks, ignore_same_music
    0) equals the one-process step on the global batch of 16, with the
    kernels on both sides, within that test's tolerances; both ranks end
    with bit-identical weights.  Skips below two cards: NCCL refuses two
    ranks on one device (chip_smoke.py's [ddp] phase runs them over gloo)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card a rank")
    import torch_port_dist_worker as W
    from mgsv_tpu_torch.config import Config
    from mgsv_tpu_torch.data.example_batch import example_batch
    from mgsv_tpu_torch.models.made import MaDe

    over = {"model.compute_dtype": "float32", "model.temporal_dropout": 0.0,
            "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0,
            "train.scheduler": "constant", "loss.ignore_same_music": 0}
    cfg = Config.from_overrides(over)
    batch = example_batch(np.random.RandomState(0), cfg, 16)
    batch["music_codes"] = np.arange(16, dtype=np.int32) % 5
    weights, batches = str(tmp_path / "w.pt"), str(tmp_path / "b.npz")
    torch.save(MaDe(cfg, torch.Generator().manual_seed(3)).state_dict(), weights)
    np.savez(batches, **{f"{k}/0": v for k, v in batch.items()})
    case = {"kind": "step", "overrides": over, "weights": weights, "batches": batches,
            "device": "cuda"}
    ranks = W.launch({"step": case}, str(tmp_path), 2, "cuda")["step"]
    for key in ranks[0]:
        if key.startswith(("param/", "grad/")):
            assert np.array_equal(ranks[0][key], ranks[1][key]), key
    want = W.run_case(case, None)
    W.assert_close_to_one_process(ranks[0], want, cfg)


def test_cuda_sharded_engine_on_two_ranks(dev, tmp_path):
    """The engine's mesh path on the card: Config()'s widths, 24 tracks of
    random tower outputs sharded over 2 ranks (gloo on one card, NCCL a card
    each on two), the DETR encoder on #1, against the one-process engine on
    #1: ids identical, scores within 1e-4, moments within 5e-3 s (the
    engine bar of chip_smoke.py); #1 launches only on a rank that holds a
    candidate, and each rank's launches equal its share of the pairs."""
    import torch_port_dist_worker as W
    from mgsv_tpu_torch.config import Config
    from mgsv_tpu_torch.models.made import MaDe
    from mgsv_tpu_torch.serve.engine import MusicIndex

    over = {"model.compute_dtype": "float32"}
    cfg = Config.from_overrides(over)
    d, s, f = cfg.model.dim_input, cfg.data.max_snippet_num, cfg.data.max_v_frames
    rng = np.random.default_rng(0)
    n = 24
    weights, index, queries = (str(tmp_path / p) for p in ("w.pt", "i.npz", "q.npz"))
    torch.save(MaDe(cfg, torch.Generator().manual_seed(3)).state_dict(), weights)
    MusicIndex([f"m{i}" for i in range(n)], rng.standard_normal((n, d), dtype=np.float32),
               rng.standard_normal((n, s, d), dtype=np.float32),
               (np.arange(s)[None] < rng.integers(1, s + 1, n)[:, None]).astype(np.float32)
               ).save(index)
    np.savez(queries, frames=rng.standard_normal((4, f, cfg.data.vit_dim), dtype=np.float32),
             fmask=(np.arange(f)[None] < rng.integers(2, f + 1, 4)[:, None]).astype(np.float32))
    case = {"kind": "engine", "overrides": over, "weights": weights, "index": index,
            "queries": queries, "queries_list": [([0], 5), ([0, 1, 2, 3], 5)],
            "device": "cuda", "fused": True, "axis": "dp"}
    ranks = W.launch({"engine": case}, str(tmp_path), 2, "cuda")["engine"]
    want = W.run_case(case, None)
    for i in range(2):
        assert int(want[f"q{i}/launches"]) == cfg.model.detr_enc_layers
        for got in ranks:
            np.testing.assert_array_equal(got[f"q{i}/ids"], want[f"q{i}/ids"])
            for key in ("retrieval_scores", "moment_scores"):
                np.testing.assert_allclose(got[f"q{i}/{key}"], want[f"q{i}/{key}"], atol=1e-4,
                                           rtol=0)
            np.testing.assert_allclose(got[f"q{i}/moments"], want[f"q{i}/moments"], atol=5e-3,
                                       rtol=0)
            held = int(got[f"q{i}/localized_rows"])
            assert int(got[f"q{i}/launches"]) == (cfg.model.detr_enc_layers if held else 0)
        assert sum(int(g[f"q{i}/localized_rows"]) for g in ranks) == int(
            want[f"q{i}/localized_rows"])


def test_cuda_ab_fingerprint(dev, tmp_path):
    """scripts/ab_kernels_cuda.py's dropout fingerprint on the card at D=256
    with short sequences (12 frames, 12 snippets, vit 64, ast 96, 2 decoder
    layers): 16 mask draws a scenario of one 16-row batch, float32.  Each
    kernel arm launches exactly its forwards (#1 and #3, and #5 in
    kernels_temporal), its "none" control lies within NONE_RTOL of the plain
    arm's, and Holm's step-down over its means and spreads is clean."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import ab_kernels_cuda as ab

    a = ab.parse_args(["--device", "cuda", "--fingerprint", "--draws", "16", "--fp-rows", "16",
                       "--out", str(tmp_path), "--report", str(tmp_path / "report.md"),
                       "--data.max_v_frames", "12", "--data.stride", "20.0",
                       "--data.filter_sec", "20.0", "--data.vit_dim", "64",
                       "--data.ast_dim", "96", "--model.detr_dec_layers", "2"])
    cfg = ab.arm_config("plain", ab.base_overrides(a))
    res = ab.run_fingerprint(a, dev, ab.make_store(str(tmp_path / "fp"), cfg, a.fp_rows, a))
    verdict = ab.fingerprint_verdict(res)
    assert ab.fingerprint_ok(verdict), verdict
