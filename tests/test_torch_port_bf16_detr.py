"""The port's DETR encoder under a bf16 compute dtype against the JAX
package's, on the CPU; and `train.mesh_shape`, which the port refuses
beyond one device.

JAX runs its fused encoder layer at precision="bf16" when the model's
compute dtype is bf16 (mgsv_tpu/models/detr.py, FusedDetrEncoderLayer):
every MXU product takes bf16 operands with float32 sums.  The port's
`fused_encoder_layer(..., precision="bf16")` does the same; on the CPU its
plain version rounds each product's operands to bf16 and multiplies in
float32.  With the same weights and inputs the two differ only by float32
summation order, so the layer is held to the float32 tolerances of
tests/test_torch_port_encoder_layer.py (forward 3e-5, gradients 2e-4),
and must lie nearer JAX's bf16 output than JAX's f32 one (they differ by
about 3e-2 here).

The whole bf16 model adds the towers, X-Pool and the decoder, which both
packages run in bf16 with roundings at different places (flax's dtype=bf16
modules against torch autocast), so a bf16 MaDe forward and train step are
held at a bf16 tolerance: outputs within 5e-2 abs (of order 1; the
observed gap is 2e-2), the loss within rtol 1e-3, and each gradient within
0.15 of its tensor's largest magnitude plus 1e-5 (observed up to 0.08: a
gradient is a sum over the batch of products of bf16-rounded factors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.models.detr import DetrEncoderLayer as JaxEncoderLayer
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.ops.pallas.fused_encoder_layer_vjp import fused_encoder_layer_train
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu_torch.cli import evaluate as evaluate_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import _mha, jax_tree_to_state_dict
from mgsv_tpu_torch.models.detr import DetrEncoderLayer
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.train.loop import Trainer
from mgsv_tpu_torch.train.optimizer import make_optimizer
from mgsv_tpu_torch.train.step import make_train_step

LAYER_ATOL, LAYER_GRAD_ATOL = 3e-5, 2e-4
MODEL_ATOL, LOSS_RTOL, GRAD_REL, GRAD_FLOOR = 5e-2, 1e-3, 0.15, 1e-5
TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "bfloat16",
        "model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0}


def _layer_state(p):
    out = {}
    _mha(out, "self_attn", p["self_attn"])
    for name in ("linear1", "linear2"):
        out[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        out[f"{name}.bias"] = np.asarray(p[name]["bias"])
    for name in ("norm1", "norm2"):
        out[f"{name}.weight"] = np.asarray(p[name]["scale"])
        out[f"{name}.bias"] = np.asarray(p[name]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.kernel
def test_encoder_layer_bf16_matches_jax_pallas_and_not_f32():
    """Forward and every gradient at precision "bf16" against JAX's Pallas
    layer and its VJP at precision="bf16" (interpret mode), rate 0; every
    row keeps a valid key (see test_torch_port_encoder_layer.py)."""
    b, L, d, heads, ffn = 3, 24, 32, 4, 64
    rng = np.random.default_rng(5)
    x, pos, g = (rng.standard_normal((b, L, d), dtype=np.float32) for _ in range(3))
    mask = (np.arange(L)[None] < rng.integers(4, L + 1, b)[:, None]).astype(np.float32)
    jlayer = JaxEncoderLayer(d, heads, ffn, dropout=0.0)
    params = jlayer.init(jax.random.PRNGKey(0), *map(jnp.asarray, (x, mask, pos)))
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    p = params["params"]
    refs = {}
    for prec in ("f32", "bf16"):
        out, vjp = jax.vjp(lambda p_, x_, pos_: fused_encoder_layer_train(
            p_, x_, jnp.asarray(mask), pos_, jnp.zeros((1,), jnp.int32), heads, 1, True, 0.0,
            prec), p, jnp.asarray(x), jnp.asarray(pos))
        refs[prec] = (np.asarray(out), vjp(jnp.asarray(g)))

    layer = DetrEncoderLayer(d, heads, ffn)
    layer.load_state_dict(_layer_state(p), strict=True)
    xt, pt = (torch.from_numpy(a).requires_grad_() for a in (x, pos))
    out = fel.fused_encoder_layer(xt, torch.from_numpy(mask), pt, layer, 0.0, 0, "bf16")
    out.backward(torch.from_numpy(g))
    out = out.detach().numpy()

    want, (dp, dx, dpos) = refs["bf16"]
    np.testing.assert_allclose(out, want, atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=LAYER_GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(dpos), atol=LAYER_GRAD_ATOL, rtol=0)
    grads = {n: q.grad.numpy() for n, q in layer.named_parameters()}
    for name, ref in _layer_state(dp).items():
        np.testing.assert_allclose(grads[name], ref.numpy(), atol=LAYER_GRAD_ATOL, rtol=0,
                                   err_msg=name)
    to_bf16 = np.abs(out - want).max()
    to_f32 = np.abs(out - refs["f32"][0]).max()
    assert to_f32 > 1e-2 and to_bf16 < to_f32 / 100, (to_bf16, to_f32)
    assert fel.fused_encoder_layer.launches == 0


def test_precision_is_checked():
    layer = DetrEncoderLayer(32, 4, 64)
    x = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="precision"):
        fel.fused_encoder_layer(x, torch.ones(1, 4), x, layer, precision="tf32")


def _configs(fused_encoder):
    overrides = {**TINY, "model.fused_detr_encoder": fused_encoder}
    return Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)


def _jax_params(jcfg):
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    return jax.device_get(jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0)))


OUT_KEYS = ("memory", "pred_logits_layers", "pred_spans_layers", "video_emb", "music_emb",
            "single_sim")


@pytest.mark.kernel
@pytest.mark.parametrize("fused_encoder", [True, False])
def test_bf16_made_forward_and_step_match_jax(fused_encoder):
    """Config() in bf16 at tiny widths, dropout off: JAX's forward and
    value_and_grad of its loss against the port's forward and one
    make_train_step (its loss and every gradient)."""
    cfg, jcfg = _configs(fused_encoder)
    batch = example_batch(np.random.RandomState(0), cfg, 8)
    params = _jax_params(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxMaDe(jcfg)

    def loss_fn(p):
        out = jmodel.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                           jb["segment_mask"], v_duration=jb["v_duration"], deterministic=True)
        return jax_total_loss(out, jb["spans_target"], jcfg)[0], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = load_jax_params(MaDe(cfg), params, cfg)
    tb = to_tensors(batch, "cpu")
    with torch.no_grad():
        out = model(tb["frame_feats"], tb["frame_mask"], tb["segment_feats"],
                    tb["segment_mask"], v_duration=tb["v_duration"])
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(jout[k], np.float32),
                                   atol=MODEL_ATOL, rtol=0, err_msg=k)
    log = make_train_step(model, cfg, make_optimizer(model, cfg, 100))(tb)
    np.testing.assert_allclose(float(log["loss"]), float(jloss), rtol=LOSS_RTOL)
    want = jax_tree_to_state_dict(jgrads, cfg)
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        tol = GRAD_REL * np.abs(want[name]).max() + GRAD_FLOOR
        assert np.abs(got - want[name]).max() <= tol, name
    assert fel.fused_encoder_layer.launches == 0


def test_mesh_shape_beyond_one_device_raises(tmp_path):
    """train.mesh_shape builds JAX's device mesh; the port runs on one device
    and refuses any other shape in the Trainer and the evaluation CLI."""
    cfg = Config.from_overrides({**TINY, "train.mesh_shape": (2, 1),
                                 "train.output_dir": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="queue 1: multi-GPU"):
        Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1: multi-GPU"):
        evaluate_cli.main(["--device", "cpu", "--train.mesh_shape", "[2, 1]"])
    Trainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_shape=(1, 1))),
            device="cpu")
