"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports nothing of JAX, so it runs on
the machine with the card, where JAX is absent:

    python3 -m pytest -m cuda tests/test_torch_port_cuda.py -q

Forward outputs agree to 1e-4 (float32 kernels with 3xTF32 GEMMs, outputs
of order 1 after LayerNorm); gradients to 1e-3 of each tensor's largest
magnitude.  The shapes are small enough that few ReLU gates sit within
rounding of zero; chip_smoke.py holds the kernels at the training shapes
against a float64 run.
"""

import numpy as np
import pytest
import torch

from mgsv_tpu_torch.core.device import resolve_device
from mgsv_tpu_torch.eval.similarity import xpool_sim_fused, xpool_similarity_blocked
from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.models.xpool import XPoolTransformer
from mgsv_tpu_torch.ops.cuda import flash_attention as fa
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
    """Ragged V and M (70 videos: a partial 64-video tile), full tiles, and
    a snippet count that is no multiple of 32."""
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


@pytest.mark.parametrize("vc,m,s", [(70, 9, 96), (33, 5, 50), (64, 40, 96)])
def test_cuda_eval_kernel_matches_plain_version(dev, vc, m, s):
    """Kernel #4 (`xpool_sim_fused` through `xpool_sim_eval`) against the
    blocked plain path, with ragged snippet masks and a partial 64-video
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
                                              (1, 2, 7, 300, True)])
def test_cuda_flash_attention_matches_plain_version(dev, dtype, atol, b, h, lq, lk, masked):
    """Kernel #7 against its plain version: ragged key masks with a fully
    masked batch row (output 0), Lq != Lk, lengths off the 64-row tiles, and
    q, k, v as strided views of one packed [B, L, 3, H, 64] tensor, as the
    towers hand them over.  float32 1e-4 (3xTF32 products), bf16 2e-2."""
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


@pytest.mark.parametrize("b,L", [(4, 96), (12, 50), (3, 21), (2, 300)])
@pytest.mark.parametrize("rate", [0.0, 0.8])
def test_cuda_temporal_kernels_match_plain_version(dev, rate, b, L):
    """The temporal layer's forward and backward kernels (#5) against
    autograd through the plain version: the towers' L = 96 and 50 (B*L of
    384 and 600 rows, a ragged last 64-row tile), fewer rows than one tile,
    and the longest L; ragged key masks with a row that keeps no key."""
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
