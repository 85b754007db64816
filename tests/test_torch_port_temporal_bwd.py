"""The plain version of the temporal layer's backward from the forward's
saved activations (ops/cuda/fused_temporal_layer.py:
`temporal_layer_acts_reference`, `temporal_layer_bwd_from_acts_reference`),
against the JAX package on the CPU.

The backward kernel (#5's) takes the forward's SAVED tensors instead of
recomputing the forward; these tests show without a card that the set is
enough: the hand-derived backward, reading x's shape, the mask, g, the
weights, the Philox masks and that set alone, gives JAX's gradients.  At
rate 0 against `jax.vjp` of `fused_temporal_layer_train` (its Pallas
kernels in interpret mode), at rate 0.8 against `jax.vjp` of
`temporal_layer_fwd_with_masks` fed the port's Philox masks; a batch row
with no valid key included.  Tolerances are tests/test_torch_port_temporal.py's:
the forward 3e-5 abs, the gradients VJP_ATOL (2e-4 abs).  On the card,
chip_smoke.py and tests/test_torch_port_cuda.py hold the kernel against
these functions and against the recomputing backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.ops.pallas.fused_temporal_layer import (fused_temporal_layer_train,
                                                      temporal_layer_fwd_with_masks)
from mgsv_tpu_torch.models.temporal import TemporalTransformer
from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.ops.cuda import fused_temporal_layer as ftl
from test_torch_port_temporal import (ATOL, VJP_ATOL, D, F, HEADS, assert_grads, inputs,
                                      layer_pair)


def plain_vjp(layer, x, mask, g, rate, seed):
    """out and {"x": dx, parameter name: gradient} from the saved set."""
    xt, mt, gt = (torch.from_numpy(a) for a in (x, mask, g))
    with torch.no_grad():
        out, acts = ftl.temporal_layer_acts_reference(xt, mt, layer, rate, seed)
        dx, grads = ftl.temporal_layer_bwd_from_acts_reference(xt, mt, gt, layer, acts, rate,
                                                               seed)
    by_tensor = dict(zip(map(id, ftl._layer_tensors(layer)), grads))
    named = {"x": dx.numpy()}
    named.update({n: by_tensor[id(p)].numpy() for n, p in layer.named_parameters()})
    return out.numpy(), named


@pytest.mark.kernel
@pytest.mark.parametrize("b,L", [(3, 10), (5, 16)])
def test_saved_set_backward_matches_pallas_vjp_at_rate_0(b, L):
    """Forward and every gradient against JAX's custom VJP (the forward and
    backward Pallas kernels in interpret mode), a row with one valid key."""
    x, mask = inputs(b, L, seed=2 * b + L)
    jp, layer, tree = layer_pair(seed=L + 3)
    g = np.random.default_rng(L).standard_normal((b, L, D), dtype=np.float32)
    seed = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(lambda p_, x_: fused_temporal_layer_train(
        p_, x_, jnp.asarray(mask), seed, HEADS, 1, True, 0.0), jp, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    out, grads = plain_vjp(layer, x, mask, g, 0.0, 0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    assert_grads(grads, dx, dp, tree, VJP_ATOL)


@pytest.mark.kernel
@pytest.mark.parametrize("rate", [0.0, 0.8])
def test_saved_set_backward_matches_the_oracle_with_the_same_masks(rate):
    """Forward and jax.vjp gradients of temporal_layer_fwd_with_masks, fed
    the port's Philox masks as numpy; a row with no valid key (uniform
    attention weights, so its v gradient is not zero)."""
    b, L, seed = 4, 13, 91
    x, mask = inputs(b, L, seed=8, dead_row=True)
    jp, layer, tree = layer_pair(seed=7)
    g = np.random.default_rng(9).standard_normal((b, L, D), dtype=np.float32)
    masks = None
    if rate > 0.0:
        masks = {k: jnp.asarray(v.numpy())
                 for k, v in philox.temporal_masks(seed, b, L, D, F, HEADS, rate).items()}
    ref, vjp = jax.vjp(lambda p_, x_: temporal_layer_fwd_with_masks(
        p_, x_, jnp.asarray(mask), masks, HEADS), jp, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    out, grads = plain_vjp(layer, x, mask, g, rate, seed)
    np.testing.assert_allclose(out, np.asarray(ref), atol=VJP_ATOL, rtol=0)
    assert_grads(grads, dx, dp, tree, VJP_ATOL)


def _layer64(seed):
    gen = torch.Generator().manual_seed(seed)
    trm = TemporalTransformer(D, 1, HEADS, F, D)
    trm.reset_parameters(gen)
    layer = trm.layers[0].double()
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return layer


@pytest.mark.parametrize("rate", [0.0, 0.8])
@pytest.mark.parametrize("b,L", [(2, 1), (3, 9), (4, 33)])
def test_saved_set_is_what_the_plain_layer_computes(b, L, rate):
    """In float64, the acts function's output is the plain layer's, and the
    backward from its saved set is autograd's through the plain layer, to
    rounding (1e-10): a length-1 sequence and a row with no valid key
    included."""
    layer = _layer64(b * L)
    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.standard_normal((b, L, D))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((b, L, D)))
    mask = torch.from_numpy((np.arange(L)[None] < rng.integers(1, L + 1, b)[:, None]) * 1.0)
    mask[-1] = 0.0
    out = ftl.fused_temporal_layer_reference(x, mask, layer, rate, 17)
    want = torch.autograd.grad(out, [x, *ftl._layer_tensors(layer)], g)
    with torch.no_grad():
        out2, acts = ftl.temporal_layer_acts_reference(x, mask, layer, rate, 17)
        dx, grads = ftl.temporal_layer_bwd_from_acts_reference(x, mask, g, layer, acts, rate, 17)
    torch.testing.assert_close(out2, out.detach(), atol=1e-10, rtol=0)
    for got, ref in zip([dx, *grads], want):
        torch.testing.assert_close(got, ref, atol=1e-10, rtol=0)


def test_saved_set_names_shapes_and_order():
    """SAVED's order is the acts function's and the kernels' (TemporalSaved
    in csrc/layer_bwd_kernels.cuh); each tensor has the shape the wrapper
    allocates, 4,114 floats a row at the paper's widths."""
    b, L, heads, f = 2, 5, 8, 1024
    shapes = ftl._saved_shapes(b, L, f, heads)
    assert ftl.SAVED == ("y", "qkv", "ctx", "z", "xh1", "inv1", "xh2", "inv2", "a1", "h1",
                         "stats")
    assert sum(int(np.prod(s)) for s in shapes) == b * L * 4114
    gen = torch.Generator().manual_seed(0)
    trm = TemporalTransformer(256, 1, heads, f, 256)
    trm.reset_parameters(gen)
    x = torch.randn(b, L, 256, generator=gen)
    _, acts = ftl.temporal_layer_acts_reference(x, torch.ones(b, L), trm.layers[0])
    assert tuple(tuple(a.shape) for a in acts) == shapes
    with open(ftl.kernels.CSRC + "/layer_bwd_kernels.cuh") as src:
        text = src.read()
    enum = text[text.index("enum TemporalSaved"):]
    names = [n.strip().lower() for n in enum[enum.index("{") + 1:enum.index("}")].split(",")]
    assert [n.removeprefix("ksaved") for n in names] == list(ftl.SAVED)


def test_the_kernel_entry_points_refuse_cpu_tensors():
    """On the CPU only the plain versions run: the training forward's
    kernel entry raises, counting no launch (the backward's is held by
    test_torch_port_temporal.py)."""
    layer = _layer64(1).float()
    x = torch.zeros(1, 4, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftl.fused_temporal_layer_fwd(x, torch.ones(1, 4), layer)
    assert ftl.fused_temporal_layer.launches == 0
