"""The port's fused decoder layer (ops/cuda/fused_decoder_layer.py, kernel
#6) against the JAX package's, on the CPU.

On the CPU the wrapper runs its plain version (the layer's own forward;
autograd is the backward kernel's plain version).  It is held against JAX's
`fused_decoder_layer_train` (the Pallas forward and backward kernels in
interpret mode) and against JAX's plain `DetrDecoderLayer(deterministic=
True)`, with the weights of a JAX `FusedDetrDecoderLayer` carried into the
port's `DetrDecoderLayer` through interop/state_dict.py (the two JAX layers
share one parameter tree).  Inputs come from a numpy seed; the key mask has
a short row and a row with one valid key.  Cases as
tests/test_fused_decoder_layer.py: (self_attn, Q) in {(True, 1), (True, 3),
(False, 1)}.  Tolerances: forward 2e-5 abs, the value rtol 2e-5, every
gradient 3e-4 abs (the JAX test's own, :47-56).  The CUDA kernels are held
against the plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.models.detr import DetrDecoderLayer as JaxDecoderLayer
from mgsv_tpu.models.detr import FusedDetrDecoderLayer as JaxFusedDecoderLayer
from mgsv_tpu.ops.pallas.fused_decoder_layer import fused_decoder_layer_train
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.interop.state_dict import _detr
from mgsv_tpu_torch.models.detr import DetrDecoderLayer
from mgsv_tpu_torch.ops.cuda import fused_decoder_layer as fdl

pytestmark = pytest.mark.kernel

B, L, D, HEADS = 5, 14, 32, 4
FWD_ATOL, VALUE_RTOL, GRAD_ATOL = 2e-5, 2e-5, 3e-4


def _inputs(q, seed):
    rng = np.random.default_rng(seed)
    tgt, qpos = (rng.standard_normal((B, q, D)).astype(np.float32) * 0.4 for _ in range(2))
    mem, pos = (rng.standard_normal((B, L, D)).astype(np.float32) * 0.4 for _ in range(2))
    mask = np.ones((B, L), np.float32)
    mask[0, 7:] = 0                     # a short row
    mask[2, 1:] = 0                     # one valid key
    cot = rng.standard_normal((B, q, D)).astype(np.float32)
    return tgt, mem, mask, pos, qpos, cot


def _cfg(self_attn):
    base = Config()
    return base.replace(model=dataclasses.replace(
        base.model, dim_input=D, detr_heads=HEADS, detr_ffn_dim=4 * D, detr_enc_layers=0,
        detr_dec_layers=1, decoder_self_attn=self_attn))


def _state(tree, self_attn):
    """A JAX decoder layer's tree (params or gradients) -> the port layer's
    state-dict names, through the port's DETR key map."""
    out = {}
    norm = {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}
    _detr(out, "d", {"dec_0": tree, "decoder_norm": norm}, _cfg(self_attn))
    prefix = "d.decoder.layers.0."
    return {k[len(prefix):]: np.asarray(v) for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("self_attn,q", [(True, 1), (True, 3), (False, 1)])
def test_fused_decoder_layer_matches_jax(self_attn, q):
    tgt, mem, mask, pos, qpos, cot = _inputs(q, seed=q + 10 * self_attn)
    jt = [jnp.asarray(a) for a in (tgt, mem, mask, pos, qpos)]
    fused = JaxFusedDecoderLayer(D, HEADS, 4 * D, self_attn=self_attn)
    params = fused.init(jax.random.PRNGKey(0), *jt)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)
    plain = JaxDecoderLayer(D, HEADS, 4 * D, dropout=0.1, self_attn=self_attn)
    mask_j = jt[2]

    def loss(fn, p, t, m, ps, qp):
        out = fn(p, t, m, ps, qp)
        return jnp.sum(out * cot), out

    kernel_fn = lambda p, t, m, ps, qp: fused_decoder_layer_train(
        p, t, m, mask_j, ps, qp, HEADS, self_attn, 2, True)
    plain_fn = lambda p, t, m, ps, qp: plain.apply(p, t, m, mask_j, ps, qp, deterministic=True)
    args = (params, jt[0], jt[1], jt[3], jt[4])
    refs = {}
    for name, fn in (("pallas", kernel_fn), ("plain", plain_fn)):
        (value, out), grads = jax.value_and_grad(
            lambda *a: loss(fn, *a), argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
        refs[name] = (float(value), np.asarray(out), jax.device_get(grads))

    layer = DetrDecoderLayer(D, HEADS, 4 * D, self_attn=self_attn)
    layer.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in _state(params["params"], self_attn).items()}, strict=True)
    ins = [torch.from_numpy(a).requires_grad_() for a in (tgt, mem, pos, qpos)]
    out = fdl.fused_decoder_layer(ins[0], ins[1], torch.from_numpy(mask), ins[2], ins[3], layer,
                                  self_attn)
    value = (out * torch.from_numpy(cot)).sum()
    value.backward()
    assert fdl.fused_decoder_layer.launches == fdl.fused_decoder_layer_bwd.launches == 0

    for name, (want_value, want_out, want_grads) in refs.items():
        np.testing.assert_allclose(out.detach().numpy(), want_out, atol=FWD_ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(float(value.detach()), want_value, rtol=VALUE_RTOL,
                                   err_msg=name)
        dparams, dtgt, dmem, dpos, dqpos = want_grads
        for t, want, what in zip(ins, (dtgt, dmem, dpos, dqpos), ("tgt", "mem", "pos", "qpos")):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=GRAD_ATOL,
                                       rtol=0, err_msg=f"{name} d{what}")
        want_state = _state(dparams["params"], self_attn)
        got_state = {n: p.grad.numpy() for n, p in layer.named_parameters()}
        assert got_state.keys() == want_state.keys()
        for n, want in want_state.items():
            np.testing.assert_allclose(got_state[n], want, atol=GRAD_ATOL, rtol=0,
                                       err_msg=f"{name} d{n}")


def test_self_attn_argument_must_match_the_layer():
    tgt, mem, mask, pos, qpos, _ = (torch.from_numpy(a) for a in _inputs(2, seed=0))
    layer = DetrDecoderLayer(D, HEADS, 4 * D, self_attn=False)
    with pytest.raises(ValueError, match="self_attn"):
        fdl.fused_decoder_layer(tgt, mem, mask, pos, qpos, layer, self_attn=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, tgt, layer)


@pytest.mark.parametrize("bad", ["shape", "dtype", "length"])
def test_backward_refuses_a_kv_that_is_not_the_forwards(bad):
    """fused_decoder_layer_bwd checks a given k|v (the forward's [B, L, 2D]
    float32) before anything else, so a wrong one raises a ValueError that
    names it, here on the CPU as on the card, before any launch; the right
    one passes that check and meets the CPU refusal."""
    tgt, mem, mask, pos, qpos, cot = (torch.from_numpy(a) for a in _inputs(2, seed=1))
    layer = DetrDecoderLayer(D, HEADS, 4 * D)
    kv = torch.zeros(B, L, 2 * D)
    bad_kv = {"shape": torch.zeros(B, L, D), "dtype": kv.double(),
              "length": torch.zeros(B, L + 1, 2 * D)}[bad]
    before = fdl.fused_decoder_layer_bwd.launches
    with pytest.raises(ValueError, match="kv"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, cot, layer, kv=bad_kv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fdl.fused_decoder_layer_bwd(tgt, mem, mask, pos, qpos, cot, layer, kv=kv)
    assert fdl.fused_decoder_layer_bwd.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "batch", "head_dim", "width", "queries",
                                 "length", "contiguous"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    """check_supported, which a CUDA call runs before its launch, refuses
    every input the kernels do not take, and takes the paper's shapes with
    and without self-attention."""
    b, q, length, d = 2, 10, 152, 256
    layer = DetrDecoderLayer(d, 8, 4 * d)
    tgt, qpos = torch.zeros(b, q, d), torch.zeros(b, q, d)
    mem, pos, mask = torch.zeros(b, length, d), torch.zeros(b, length, d), torch.ones(b, length)
    if bad == "dtype":
        mem = mem.double()
    elif bad == "shape":
        pos = torch.zeros(b, length + 1, d)
    elif bad == "batch":
        tgt, qpos = torch.zeros(b + 1, q, d), torch.zeros(b + 1, q, d)
    elif bad == "head_dim":
        layer = DetrDecoderLayer(d, 4, 4 * d)
    elif bad == "width":
        layer = DetrDecoderLayer(d, 8, 3 * d // 2)
    elif bad == "queries":
        tgt, qpos = torch.zeros(b, fdl.MAX_L + 1, d), torch.zeros(b, fdl.MAX_L + 1, d)
    elif bad == "length":
        mem, pos = torch.zeros(b, fdl.MAX_L + 1, d), torch.zeros(b, fdl.MAX_L + 1, d)
        mask = torch.ones(b, fdl.MAX_L + 1)
    else:
        mem = torch.zeros(b, d, length).transpose(1, 2)
    with pytest.raises(ValueError):
        fdl.check_supported(tgt, mem, mask, pos, qpos, layer)
    for self_attn in (True, False):
        fdl.check_supported(torch.zeros(b, q, d), torch.zeros(b, length, d), torch.ones(b, length),
                            torch.zeros(b, length, d), torch.zeros(b, q, d),
                            DetrDecoderLayer(d, 8, 4 * d, self_attn=self_attn))
