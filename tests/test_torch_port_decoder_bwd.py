"""The plain version of the decoder layer's backward from the forward's
saved set (ops/cuda/fused_decoder_layer.py: `decoder_layer_acts_reference`,
`decoder_layer_bwd_from_acts_reference`), against the JAX package on the
CPU.

The backward kernel (#6's) takes the training forward's SAVED tensors
instead of recomputing the forward; these tests show without a card that
the set is enough: the hand-derived backward, reading the inputs, the mask,
g, the weights and that set alone (each attention's weights rebuilt from
its saved statistics, D_i = dctx_i . ctx_i), gives the gradients of
`jax.vjp` of `fused_decoder_layer_train` (its Pallas kernels in interpret
mode), for (self_attn, Q) in {(True, 1), (True, 3), (False, 1)} and Q > L,
with tests/test_torch_port_decoder_layer.py's inputs (a short row and a
row with one valid key) and tolerances: the forward 2e-5 abs, every
gradient 3e-4 abs.  On the card, chip_smoke.py and
tests/test_torch_port_cuda.py hold the kernel against these functions and
against the recomputing backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.models.detr import FusedDetrDecoderLayer as JaxFusedDecoderLayer
from mgsv_tpu.ops.pallas.fused_decoder_layer import fused_decoder_layer_train
from mgsv_tpu_torch.models.detr import DetrDecoderLayer
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl
from test_torch_port_decoder_layer import D, FWD_ATOL, GRAD_ATOL, HEADS, _inputs, _state


def _pair(self_attn, inputs):
    """A JAX layer's perturbed parameters and the port layer holding them."""
    jt = [jnp.asarray(a) for a in inputs[:5]]
    params = JaxFusedDecoderLayer(D, HEADS, 4 * D, self_attn=self_attn).init(
        jax.random.PRNGKey(0), *jt)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)
    layer = DetrDecoderLayer(D, HEADS, 4 * D, self_attn=self_attn)
    layer.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in _state(params["params"], self_attn).items()}, strict=True)
    return params, layer


def plain_vjp(layer, tgt, mem, mask, pos, qpos, g):
    """out, (dtgt, dmem, dpos, dqpos) and {parameter name: gradient} from
    the saved set."""
    ins = [torch.from_numpy(a) for a in (tgt, mem, mask, pos, qpos, g)]
    with torch.no_grad():
        out, acts = fdl.decoder_layer_acts_reference(*ins[:5], layer)
        *dins, grads = fdl.decoder_layer_bwd_from_acts_reference(*ins, layer, acts)
    by_tensor = dict(zip(map(id, fdl._layer_tensors(layer)), grads))
    named = {n: by_tensor[id(p)].numpy() for n, p in layer.named_parameters()}
    return out.numpy(), [t.numpy() for t in dins], named


@pytest.mark.kernel
@pytest.mark.parametrize("self_attn,q", [(True, 1), (True, 3), (False, 1), (True, 16)])
def test_saved_set_backward_matches_pallas_vjp(self_attn, q):
    """Forward and every gradient against JAX's custom VJP (the forward and
    backward Pallas kernels in interpret mode); Q = 16 > L = 14 included."""
    tgt, mem, mask, pos, qpos, g = _inputs(q, seed=q + 10 * self_attn)
    params, layer = _pair(self_attn, (tgt, mem, mask, pos, qpos))
    mask_j = jnp.asarray(mask)
    ref, vjp = jax.vjp(lambda p_, t_, m_, ps_, qp_: fused_decoder_layer_train(
        p_, t_, m_, mask_j, ps_, qp_, HEADS, self_attn, 2, True),
        params, *(jnp.asarray(a) for a in (tgt, mem, pos, qpos)))
    dparams, *dins_j = vjp(jnp.asarray(g))
    out, dins, grads = plain_vjp(layer, tgt, mem, mask, pos, qpos, g)
    np.testing.assert_allclose(out, np.asarray(ref), atol=FWD_ATOL, rtol=0)
    for got, want, what in zip(dins, dins_j, ("tgt", "mem", "pos", "qpos")):
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{what}")
    want_state = _state(jax.device_get(dparams)["params"], self_attn)
    assert grads.keys() == want_state.keys()
    for n, want in want_state.items():
        np.testing.assert_allclose(grads[n], want, atol=GRAD_ATOL, rtol=0, err_msg=f"d{n}")


def _layer64(self_attn, seed):
    gen = torch.Generator().manual_seed(seed)
    layer = DetrDecoderLayer(D, HEADS, 4 * D, self_attn=self_attn)
    layer.reset_parameters(gen)
    layer = layer.double()
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return layer


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("b,q,L", [(2, 1, 1), (3, 4, 9), (2, 12, 5)])
def test_saved_set_is_what_the_plain_layer_computes(self_attn, b, q, L):
    """In float64, the acts function's output is the plain layer's, and the
    backward from its saved set is autograd's through the plain layer, to
    rounding (1e-10): one memory row, Q > L, a row with one valid key and a
    row with none (uniform weights) included."""
    layer = _layer64(self_attn, b * q + L)
    rng = np.random.default_rng(L)
    tgt, qpos, g = (torch.from_numpy(rng.standard_normal((b, q, D))) for _ in range(3))
    mem, pos = (torch.from_numpy(rng.standard_normal((b, L, D))) for _ in range(2))
    mask = torch.from_numpy((np.arange(L)[None] < rng.integers(1, L + 1, b)[:, None]) * 1.0)
    mask[0] = 0.0
    mask[0, 0] = 1.0
    mask[-1] = 0.0
    leaves = [t.clone().requires_grad_() for t in (tgt, mem, pos, qpos)]
    out = fdl.fused_decoder_layer_reference(leaves[0], leaves[1], mask, leaves[2], leaves[3],
                                            layer)
    want = torch.autograd.grad(out, [*leaves, *fdl._layer_tensors(layer)], g)
    with torch.no_grad():
        out2, acts = fdl.decoder_layer_acts_reference(tgt, mem, mask, pos, qpos, layer)
        *dins, grads = fdl.decoder_layer_bwd_from_acts_reference(tgt, mem, mask, pos, qpos, g,
                                                                 layer, acts)
    torch.testing.assert_close(out2, out.detach(), atol=1e-10, rtol=0)
    for got, ref in zip([*dins, *grads], want):
        torch.testing.assert_close(got, ref, atol=1e-10, rtol=0)


@pytest.mark.parametrize("self_attn", [True, False])
def test_saved_set_names_shapes_and_order(self_attn):
    """SAVED's order is the acts function's and the kernels' (DecoderSaved
    in csrc/decoder_layer_kernels.cuh); each tensor has the shape the
    wrapper allocates (None for the self-attention's without it): 3,875
    floats a query row with self-attention at the paper's widths, 2,322
    without, and 512 a memory row."""
    b, q, L, heads, f = 2, 3, 5, 8, 1024
    shapes = fdl._saved_shapes(b, q, L, f, heads, self_attn)
    assert fdl.SAVED == ("kv", "sa_qkv", "sa_ctx", "sa_stats", "t1", "xh1", "inv1", "q", "ctx",
                         "stats", "t2", "xh2", "inv2", "h1", "xh3", "inv3")
    assert [s is None for s in shapes] == [
        not self_attn and name in ("sa_qkv", "sa_ctx", "sa_stats", "t1", "xh1", "inv1")
        for name in fdl.SAVED]
    assert shapes[0] == (b, L, 512)
    per_row = (3875 if self_attn else 2322)
    assert sum(int(np.prod(s)) for s in shapes[1:] if s is not None) == b * q * per_row
    layer = DetrDecoderLayer(256, heads, f, self_attn=self_attn)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    ins = [torch.randn(b, n, 256, generator=gen) for n in (q, L, L, q)]
    _, acts = fdl.decoder_layer_acts_reference(ins[0], ins[1], torch.ones(b, L), ins[2], ins[3],
                                               layer)
    assert tuple(None if a is None else tuple(a.shape) for a in acts) == shapes
    with open(fdl.kernels.CSRC + "/decoder_layer_kernels.cuh") as src:
        text = src.read()
    enum = text[text.index("enum DecoderSaved"):]
    names = [n.strip().lower() for n in enum[enum.index("{") + 1:enum.index("}")].split(",")]
    assert [n.removeprefix("kdec") for n in names] == [n.replace("_", "") for n in fdl.SAVED]


def test_the_kernel_entry_points_refuse_cpu_tensors():
    """On the CPU only the plain versions run: the training forward's
    kernel entry raises, counting no launch."""
    tgt, mem, mask, pos, qpos, _ = (torch.from_numpy(a) for a in _inputs(2, seed=0))
    layer = DetrDecoderLayer(D, HEADS, 4 * D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fdl.fused_decoder_layer_fwd(tgt, mem, mask, pos, qpos, layer)
    assert fdl.fused_decoder_layer.launches == 0


@pytest.mark.parametrize("bad", ["count", "shape", "dtype", "missing", "both"])
def test_backward_refuses_a_saved_set_that_is_not_the_forwards(bad):
    """fused_decoder_layer_bwd checks a given saved set before anything
    else, so one that is not the forward's (a tensor short, of another
    shape or dtype, one missing, or given beside kv) raises a ValueError
    before any launch; the right one passes that check and meets the CPU
    refusal."""
    tgt, mem, mask, pos, qpos, cot = (torch.from_numpy(a) for a in _inputs(2, seed=1))
    layer = DetrDecoderLayer(D, HEADS, 4 * D)
    with torch.no_grad():
        acts = list(fdl.decoder_layer_acts_reference(tgt, mem, mask, pos, qpos, layer)[1])
    bad_acts, kv = list(acts), None
    if bad == "count":
        bad_acts = bad_acts[:-1]
    elif bad == "shape":
        bad_acts[7] = bad_acts[7][:, :1].contiguous()
    elif bad == "dtype":
        bad_acts[13] = bad_acts[13].double()
    elif bad == "missing":
        bad_acts[2] = None
    else:
        kv = acts[0]
    before = fdl.fused_decoder_layer_bwd.launches
    with pytest.raises(ValueError, match="acts"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, cot, layer, kv=kv, acts=bad_acts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, cot, layer, acts=acts)
    assert fdl.fused_decoder_layer_bwd.launches == before
