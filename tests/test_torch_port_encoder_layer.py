"""The port's fused encoder layer and the DETR forward vs the JAX package.

On the CPU the wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode (rate 0) and against the mask-fixed JAX
oracle `layer_fwd_with_masks`, atol 3e-5 as in tests/test_detr_fused.py.
With gradients (autograd of the plain version, which is the backward
kernel's plain version) and dropout fed the same Philox masks, atol 2e-4,
JAX's own tolerance for this layer's VJP (tests/test_fused_layer_vjp.py).
The CUDA kernels themselves are held against the plain version on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config
from mgsv_tpu.interop.torch_export import _detr, _mha
from mgsv_tpu.models.detr import DetrEncoderLayer as JaxEncoderLayer, DetrTransformer
from mgsv_tpu.ops.pallas.detr_fused import detr_forward_fused as jax_detr_forward_fused
from mgsv_tpu.ops.pallas.fused_encoder_layer import (fused_encoder_layer as jax_fused,
                                                     layer_fwd_with_masks)
from mgsv_tpu.ops.pallas.fused_encoder_layer_vjp import fused_encoder_layer_train
from mgsv_tpu_torch.models.detr import DetrEncoderLayer, DetrTransformer as TorchDetr
from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel

ATOL = 3e-5
VJP_ATOL = 2e-4


def _linear(prefix, p):
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T, f"{prefix}.bias": np.asarray(p["bias"])}


def encoder_state(p):
    """flax DetrEncoderLayer params -> the port's DetrEncoderLayer state dict."""
    out = {}
    _mha(out, "self_attn", p["self_attn"])
    out.update(_linear("linear1", p["linear1"]))
    out.update(_linear("linear2", p["linear2"]))
    for n in ("norm1", "norm2"):
        out[f"{n}.weight"] = np.asarray(p[n]["scale"])
        out[f"{n}.bias"] = np.asarray(p[n]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def inputs(b, L, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, d), dtype=np.float32)
    pos = rng.standard_normal((b, L, d), dtype=np.float32)
    mask = (np.arange(L)[None] < rng.integers(1, L + 1, b)[:, None]).astype(np.float32)
    mask[0] = 1
    mask[-1] = 0                       # fully masked row: uniform softmax, no NaN
    return x, pos, mask


@pytest.mark.kernel
@pytest.mark.parametrize("b,L,d,heads", [(6, 16, 32, 4), (3, 21, 64, 2), (2, 152, 64, 2)])
def test_plain_version_matches_pallas_and_oracle(b, L, d, heads):
    x, pos, mask = inputs(b, L, d, seed=b + L)
    jlayer = JaxEncoderLayer(d, heads, 4 * d, dropout=0.0)
    params = perturbed(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(mask), jnp.asarray(pos)), seed=1)
    pallas = jax_fused(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos), params,
                       heads=heads, block_b=4, interpret=True, rate=0.0)
    oracle = layer_fwd_with_masks(params["params"], jnp.asarray(x), jnp.asarray(mask),
                                  jnp.asarray(pos), None, heads)

    layer = DetrEncoderLayer(d, heads, 4 * d)
    layer.load_state_dict(encoder_state(params["params"]), strict=True)
    with torch.no_grad():
        xt, mt, pt = map(torch.from_numpy, (x, mask, pos))
        out = fel.fused_encoder_layer(xt, mt, pt, layer)
        module = layer(xt, mt, pt)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(module.numpy(), out.numpy(), atol=ATOL, rtol=0)
    assert fel.fused_encoder_layer.launches == 0     # CPU tensors never launch


@pytest.mark.kernel
def test_detr_forward_fused_matches_jax():
    b, L, d, heads, enc, dec = 5, 18, 32, 4, 2, 3
    x, pos, mask = inputs(b, L, d, seed=7)
    rng = np.random.default_rng(8)
    query = rng.standard_normal((1, d), dtype=np.float32)
    target = rng.standard_normal((b, 1, d), dtype=np.float32)
    detr = DetrTransformer(d, heads, 2 * d, enc_layers=enc, dec_layers=dec, dropout=0.0,
                           decoder_self_attn=True)
    args = tuple(map(jnp.asarray, (x, mask, pos, query, target)))
    params = perturbed(detr.init(jax.random.PRNGKey(0), *args, deterministic=True), seed=2)
    hid_ref, mem_ref = jax_detr_forward_fused(
        params, *args, heads=heads, ffn_dim=2 * d, enc_layers=enc, dec_layers=dec,
        decoder_self_attn=True, block_b=4, interpret=True)

    base = Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, detr_enc_layers=enc, detr_dec_layers=dec, decoder_self_attn=True))
    state = {}
    _detr(state, "d", params["params"], cfg)
    tdetr = TorchDetr(d, heads, 2 * d, enc, dec, decoder_self_attn=True)
    tdetr.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    with torch.no_grad():                  # CPU tensors: each encoder layer's plain version
        hid, mem = tdetr(*map(torch.from_numpy, (x, mask, pos)),
                         torch.from_numpy(query), torch.from_numpy(target))
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_ref), atol=ATOL, rtol=0)


def _encoder_pair(b, L, d, heads, ffn, seed):
    x, pos, mask = inputs(b, L, d, seed=seed)
    jlayer = JaxEncoderLayer(d, heads, ffn, dropout=0.0)
    params = perturbed(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(mask), jnp.asarray(pos)), seed=seed + 1)
    layer = DetrEncoderLayer(d, heads, ffn)
    layer.load_state_dict(encoder_state(params["params"]), strict=True)
    g = np.random.default_rng(seed + 2).standard_normal((b, L, d), dtype=np.float32)
    return x, pos, mask, g, params["params"], layer


def _port_vjp(layer, x, mask, pos, g, rate, seed):
    xt, pt = (torch.from_numpy(a).requires_grad_() for a in (x, pos))
    out = fel.fused_encoder_layer(xt, torch.from_numpy(mask), pt, layer, rate, seed)
    out.backward(torch.from_numpy(g))
    grads = {"x": xt.grad, "pos": pt.grad}
    grads.update({n: p.grad for n, p in layer.named_parameters()})
    return out.detach().numpy(), {k: v.numpy() for k, v in grads.items()}


def _assert_grads(grads, dx, dpos, dp, atol):
    np.testing.assert_allclose(grads["x"], np.asarray(dx), atol=atol, rtol=0)
    np.testing.assert_allclose(grads["pos"], np.asarray(dpos), atol=atol, rtol=0)
    for name, ref in encoder_state(dp).items():
        np.testing.assert_allclose(grads[name], ref.numpy(), atol=atol, rtol=0, err_msg=name)


@pytest.mark.kernel
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_forward_and_grads_match_jax_with_the_same_masks(rate):
    """Forward and every gradient against jax.vjp of layer_fwd_with_masks,
    fed the port's Philox masks as numpy."""
    b, L, d, heads, ffn, seed = 3, 13, 32, 4, 64, 21
    x, pos, mask, g, p, layer = _encoder_pair(b, L, d, heads, ffn, seed)
    masks = None
    if rate > 0.0:
        masks = {k: jnp.asarray(v.numpy()) for k, v in philox.encoder_masks(
            seed, b, L, d, ffn, heads, rate).items()}
    ref, vjp = jax.vjp(lambda p_, x_, pos_: layer_fwd_with_masks(
        p_, x_, jnp.asarray(mask), pos_, masks, heads), p, jnp.asarray(x), jnp.asarray(pos))
    dp, dx, dpos = vjp(jnp.asarray(g))
    out, grads = _port_vjp(layer, x, mask, pos, g, rate, seed)
    np.testing.assert_allclose(out, np.asarray(ref), atol=VJP_ATOL, rtol=0)
    _assert_grads(grads, dx, dpos, dp, VJP_ATOL)
    if rate > 0.0:                     # dropout really acted
        _, plain = _port_vjp(layer, x, mask, pos, g, 0.0, seed)
        assert np.abs(plain["x"] - grads["x"]).max() > 10 * VJP_ATOL


@pytest.mark.kernel
def test_plain_grads_match_fused_encoder_layer_train_at_rate_0():
    """Against the TPU kernels' custom VJP (forward and backward Pallas
    kernels in interpret mode)."""
    b, L, d, heads, ffn, seed = 2, 16, 32, 4, 64, 5
    x, pos, mask, g, p, layer = _encoder_pair(b, L, d, heads, ffn, seed)
    # The Pallas backward does not zero the softmax gradient of masked keys,
    # which differs from autograd only in a row with no valid key (uniform
    # softmax).  MaDe never makes one (its first frame is always valid), and
    # JAX's own test of that VJP has none, so every row keeps a valid key.
    mask[:, :3] = 1
    ref, vjp = jax.vjp(lambda p_, x_, pos_: fused_encoder_layer_train(
        p_, x_, jnp.asarray(mask), pos_, jnp.zeros((1,), jnp.int32), heads, 1, True, 0.0),
        p, jnp.asarray(x), jnp.asarray(pos))
    dp, dx, dpos = vjp(jnp.asarray(g))
    out, grads = _port_vjp(layer, x, mask, pos, g, 0.0, 0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=VJP_ATOL, rtol=0)
    _assert_grads(grads, dx, dpos, dp, VJP_ATOL)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    layer = DetrEncoderLayer(256, 8, 1024)
    x = torch.zeros(1, 4, 256)
    with pytest.raises(ValueError):
        fel.fused_encoder_layer_bwd(x, torch.ones(1, 4), x, x, layer)
    assert fel.fused_encoder_layer_bwd.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "head_dim", "width", "length",
                                 "contiguous", "layer_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, L, d, heads = 2, 16, 256, 8
    layer = DetrEncoderLayer(d, heads, 4 * d)
    x = torch.zeros(b, L, d)
    pos, mask = torch.zeros(b, L, d), torch.ones(b, L)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        pos = torch.zeros(b, L + 1, d)
    elif bad == "head_dim":
        layer = DetrEncoderLayer(d, 4, 4 * d)
    elif bad == "width":
        layer = DetrEncoderLayer(d, heads, 3 * d // 2)
    elif bad == "length":
        x, pos, mask = (torch.zeros(b, fel.MAX_L + 1, d), torch.zeros(b, fel.MAX_L + 1, d),
                        torch.ones(b, fel.MAX_L + 1))
    elif bad == "contiguous":
        x = torch.zeros(b, d, L).transpose(1, 2)
    else:                              # the layer's width differs from the input's
        layer = DetrEncoderLayer(d // 2, heads, 4 * d)
    with pytest.raises(ValueError):
        fel.check_supported(x, mask, pos, layer)
    fel.check_supported(torch.zeros(b, L, d), torch.ones(b, L), torch.zeros(b, L, d),
                        DetrEncoderLayer(d, 8, 4 * d))


def test_weight_check_runs_again_after_the_weights_move():
    layer = DetrEncoderLayer(256, 8, 1024)
    cpu = torch.device("cpu")
    assert fel._weights(layer, cpu)[0] is layer.self_attn.in_proj_weight
    assert layer in fel._checked_weights
    layer.double()                     # new storage: the check runs again and fails
    with pytest.raises(ValueError):
        fel._weights(layer, cpu)
