"""The port's training step (train/schedule.py, train/optimizer.py,
train/step.py, MaDe.forward, train/objective.py) vs the JAX package's, at the
tiny widths of the verify recipe (D=32, FFN 64, 1 encoder and 2 decoder
layers, batch 8), in float32 on the CPU.

The JAX step runs its default kernels: the fused X-Pool similarity and the
fused encoder layer, forward and backward Pallas kernels in interpret mode.
The port's wrappers run their plain versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu.train.objective import total_loss as jax_total_loss
from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mgsv_tpu.train.schedule import make_schedule as jax_make_schedule
from mgsv_tpu.train.step import create_state, make_train_step as jax_make_train_step
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps
from mgsv_tpu_torch.train.optimizer import FROZEN, make_optimizer, param_groups
from mgsv_tpu_torch.train.schedule import make_schedule
from mgsv_tpu_torch.train.step import make_train_step

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32"}
NO_DROPOUT = {"model.temporal_dropout": 0.0, "model.xpool_dropout": 0.0,
              "model.detr_dropout": 0.0}
BATCH = 8
HORIZON = 100


def _configs(**extra):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)


def _jax_params(jcfg, batch):
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    return jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0))


def _assert_state(model, tree, cfg, atol, rtol, what):
    want = jax_tree_to_state_dict(tree, cfg)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", ["warmupcosine", "warmuplinear", "warmupconstant",
                                  "constant", "exponential"])
def test_schedules_match_jax(name):
    """The lr of every update count 0..199, float32 on both sides."""
    args = (name, 3e-4, 20, 150)
    ours = make_schedule(*args, decay_rate=0.9, lr_update_rate=7)
    ref = jax_make_schedule(*args, decay_rate=0.9, lr_update_rate=7)
    counts = np.arange(200)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts, jnp.float32)))
    got = np.array([ours(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name.startswith("warmup"):
        assert got[0] == 0.0                           # the first update changes nothing


def test_optimizer_matches_optax_on_identical_gradients():
    """Three updates from the same numpy gradients; the temporal group's are
    scaled below the clipping norm, the others' above it."""
    cfg, jcfg = _configs(**{"train.scheduler": "constant"})
    params = _jax_params(jcfg, None)
    model = load_jax_params(MaDe(cfg), params, cfg)
    tx = jax_make_optimizer(jcfg, HORIZON)
    opt_state = tx.init(params)
    opt = make_optimizer(model, cfg, HORIZON)
    rng = np.random.default_rng(0)
    names = {id(p): n for n, p in model.named_parameters()}
    for step in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
                             params)
        grads["params"]["video_tower"] = jax.tree.map(lambda g: g * 1e-4,
                                                      grads["params"]["video_tower"])
        grads["params"]["audio_tower"] = jax.tree.map(lambda g: g * 1e-4,
                                                      grads["params"]["audio_tower"])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state_grads = jax_tree_to_state_dict(grads, cfg)
        for p in model.parameters():
            p.grad = torch.from_numpy(state_grads[names[id(p)]].copy())
        opt.step()
        _assert_state(model, params, cfg, atol=1e-6, rtol=1e-5, what=f"update {step}")
    frozen = [n for n, _ in param_groups(model)[FROZEN]]
    assert frozen == ["decoder_query_embed.weight"]


def _jax_step(jcfg, params, batch):
    """JAX's loss and gradients (value_and_grad of make_train_step's loss)
    and the log and parameters after its make_train_step."""
    model = JaxMaDe(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = model.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                          jb["segment_mask"], v_duration=jb["v_duration"],
                          deterministic=False, rngs={"dropout": key})
        return jax_total_loss(out, jb["spans_target"], jcfg)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_make_optimizer(jcfg, HORIZON)
    state = create_state(model, jcfg, tx, jax.random.PRNGKey(0), jb)
    state = state.replace(params=params, opt_state=tx.init(params))
    state, log = jax_make_train_step(model, jcfg)(state, jb, key)
    return float(loss), grads, jax.device_get(log), jax.device_get(state.params)


def _assert_update(model, before, after, grads, cfg, lr, grad_atol, grad_rtol):
    """The parameters after one Adam update against JAX's.  The first update
    moves each element by lr * g / (|g| + eps), which is lr * sign(g) where
    |g| >> eps: elements whose gradient is within the gradient tolerance of
    zero may take the other sign (or a fraction of lr) in either framework
    and get 2 lr; every other element must agree to float32 rounding of the
    weight (atol 1e-6).  Elements of the frozen group must not move at all."""
    want = jax_tree_to_state_dict(after, cfg)
    start = jax_tree_to_state_dict(before, cfg)
    g = jax_tree_to_state_dict(grads, cfg)
    frozen = {n for n, _ in param_groups(model, cfg.train.train_query_embed)[FROZEN]}
    moved = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if name in frozen:
            np.testing.assert_array_equal(got, start[name], err_msg=name)
            np.testing.assert_array_equal(want[name], start[name], err_msg=name)
            continue
        near_zero = np.abs(g[name]) <= grad_atol + grad_rtol * np.abs(g[name])
        tol = np.where(near_zero, 2 * lr, 0.0) + 1e-6
        err = np.abs(got - want[name])
        assert (err <= tol).all(), f"{name}: max error {err.max()} (near-zero grads " \
                                   f"{near_zero.sum()} of {near_zero.size})"
        moved += int((np.abs(want[name] - start[name]) > lr / 2).sum())
    assert moved > 0


@pytest.mark.kernel
@pytest.mark.parametrize("scheduler", ["warmupcosine", "constant"])
def test_train_step_matches_jax(scheduler):
    """One make_train_step in float32, every dropout at 0, the weights carried
    across.  Loss rtol 1e-5.  Gradients: atol 1e-5 plus rtol 1e-4 of each
    element; the forward runs through two temporal towers, X-Pool, three
    DETR layers and the heads, and the InfoNCE logits are scaled by
    1/0.03, so float32 rounding in another summation order reaches a few
    1e-6 in the largest gradients.  The parameters after the step: with
    warmup-cosine lr(0) = 0 and nothing moves; with a constant schedule
    the update inside the step (the update count the schedule reads, the
    frozen group) is held against JAX's (_assert_update)."""
    cfg, jcfg = _configs(**NO_DROPOUT, **{"train.scheduler": scheduler})
    batch = example_batch(np.random.RandomState(0), cfg, BATCH)
    params = jax.device_get(_jax_params(jcfg, batch))
    loss, grads, jax_log, jax_new = _jax_step(jcfg, params, batch)

    model = load_jax_params(MaDe(cfg), params, cfg)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON))
    log = step(to_tensors(batch, "cpu"))
    assert fel.fused_encoder_layer.launches == xps.xpool_sim_fwd.launches == 0

    np.testing.assert_allclose(float(log["loss"]), loss, rtol=1e-5)
    assert log.keys() == jax_log.keys()
    for k, v in jax_log.items():
        np.testing.assert_allclose(log[k].numpy(), np.asarray(v), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    want = jax_tree_to_state_dict(grads, cfg)
    for name, p in model.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=1e-4, err_msg=name)
    lr = make_schedule(scheduler, cfg.train.matching_lr, int(HORIZON * cfg.train.warmup_rate),
                       HORIZON)(0)
    assert cfg.train.detection_lr == cfg.train.matching_lr
    if lr == 0.0:          # warmup-cosine: lr(0) = 0, so the first update leaves every weight
        _assert_state(model, jax_new, cfg, atol=0, rtol=0, what="after the step")
    else:
        _assert_update(model, params, jax_new, grads, cfg, lr, grad_atol=1e-5, grad_rtol=1e-4)


def test_train_step_with_dropout_moves_the_weights_reproducibly():
    """Dropout on, two steps: finite, seeded by (seed, step) so a rerun from
    the same weights gives the same losses, and different from the run
    without dropout."""
    cfg, _ = _configs(**{"train.scheduler": "constant"})
    batch = to_tensors(example_batch(np.random.RandomState(1), cfg, BATCH), "cpu")
    runs = []
    for c in (cfg, Config.from_overrides({**TINY, **NO_DROPOUT,
                                         "train.scheduler": "constant"}), cfg):
        model = MaDe(c, torch.Generator().manual_seed(0))
        step = make_train_step(model, c, make_optimizer(model, c, HORIZON))
        runs.append([float(step(batch)["loss"]) for _ in range(2)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[2]
    assert runs[0][0] != runs[1][0]
    assert runs[0][1] != runs[0][0]                   # the first update moved the weights
