"""Gradient accumulation in the port (train/optimizer.py, train/step.py,
train/loop.py) against the JAX package's optax.MultiSteps, on the CPU at
the tiny widths of the verify recipe: the optimizer on the same gradient
sequence (updates every k-th micro-step, the horizon divided by k, the
frozen query embedding), k = 1 equal to the plain update bit for bit, the
whole training step with k = 2 against JAX's, and a run preempted in the
middle of an accumulation resumed bit for bit."""

import dataclasses

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
from mgsv_tpu.train.step import create_state, make_train_step as jax_make_train_step
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data import synthetic
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.interop.from_jax import load_jax_params
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.loop import Preempted, Trainer
from mgsv_tpu_torch.train.optimizer import (DETECTION, FROZEN, GroupedAdam, global_norm,
                                            make_optimizer, param_groups)
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
MICRO_STEPS = 8


def _configs(**extra):
    overrides = {**TINY, **extra}
    return Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)


def _jax_params(jcfg):
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    return jax.device_get(jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0)))


def _assert_state(model, tree, cfg, atol, rtol, what):
    want = jax_tree_to_state_dict(tree, cfg)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {name}")


def _gradient_sequence(params, n, seed=0):
    """n seeded gradient trees shaped like params, the temporal towers'
    scaled below the clipping norm and the other groups' above it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
                         params)
        for tower in ("video_tower", "audio_tower"):
            g["params"][tower] = jax.tree.map(lambda x: x * 1e-4, g["params"][tower])
        out.append(g)
    return out


def _set_grads(model, tree, cfg):
    grads = jax_tree_to_state_dict(tree, cfg)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name].copy())


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """MICRO_STEPS micro-steps of the same gradients through JAX's
    make_optimizer (optax.MultiSteps) and the port's: the parameters and
    the accumulated mean agree after every micro-step, the parameters move
    only at every k-th, the update count advances only then, and
    decoder_query_embed never moves."""
    cfg, jcfg = _configs(**{"train.scheduler": "constant",
                            "train.gradient_accumulation_steps": k})
    params = _jax_params(jcfg)
    model = load_jax_params(MaDe(cfg), params, cfg)
    tx = jax_make_optimizer(jcfg, HORIZON)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    opt = make_optimizer(model, cfg, HORIZON)
    frozen = [p for _, p in param_groups(model)[FROZEN]]
    assert len(frozen) == 1
    frozen_start = frozen[0].detach().clone()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for step, grads in enumerate(_gradient_sequence(params, MICRO_STEPS)):
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads, cfg)
        opt.step()
        _assert_state(model, params, cfg, atol=1e-6, rtol=1e-5, what=f"micro-step {step}")
        fired = (step + 1) % k == 0
        moved = any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
        assert moved == fired, step
        assert (opt.count, opt.mini_step, opt.micro_step) == ((step + 1) // k, (step + 1) % k,
                                                              step + 1)
        assert int(opt_state.gradient_step) == opt.count
        assert int(opt_state.mini_step) == opt.mini_step
        # the running mean itself (Adam all but ignores a constant scale,
        # so the parameters alone would not tell a mean from a sum)
        acc = jax_tree_to_state_dict(jax.device_get(opt_state.acc_grads), cfg)
        for name, a in opt.state_dict()["acc_grads"].items():
            np.testing.assert_allclose(a.numpy(), acc[name], atol=1e-6, rtol=1e-5,
                                       err_msg=f"micro-step {step}: acc {name}")
        assert torch.equal(frozen[0], frozen_start)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}


def test_horizon_is_divided_by_k():
    """The schedules count updates: 40 micro-batches at k = 2 make a
    20-update warmup-cosine, so both JAX's and the port's last update runs
    at the end of the cosine, and the parameters agree throughout."""
    total = 40
    cfg, jcfg = _configs(**{"train.gradient_accumulation_steps": 2})
    params = _jax_params(jcfg)
    model = load_jax_params(MaDe(cfg), params, cfg)
    tx = jax_make_optimizer(jcfg, total)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    opt = make_optimizer(model, cfg, total)
    t = cfg.train
    want = make_schedule(t.scheduler, t.matching_lr, int(total // 2 * t.warmup_rate),
                         total // 2)
    for c in range(total // 2):
        assert opt.schedules[DETECTION](c) == want(c)
    for grads in _gradient_sequence(params, total, seed=1):
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads, cfg)
        opt.step()
    _assert_state(model, params, cfg, atol=1e-6, rtol=1e-5, what="after 40 micro-steps")
    assert opt.count == total // 2
    # the last update at the cosine's end; an undivided 40-update horizon
    # would put it at half the base rate
    assert opt.schedules[DETECTION](opt.count - 1) < 0.01 * t.detection_lr


@torch.no_grad()
def _plain_update(opt: GroupedAdam) -> None:
    """The un-accumulated three-group update, op for op in optax's order:
    at k = 1 the optimizer's step must give exactly these bits."""
    k = opt.count + 1
    for group, schedule in opt.schedules.items():
        named = opt.groups[group]
        params = [p for _, p in named]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        mus = [opt.state[name][0] for name, _ in named]
        nus = [opt.state[name][1] for name, _ in named]
        bc1, bc2 = (1.0 - torch.full((), b, dtype=torch.float32) ** k for b in (opt.b1, opt.b2))
        norm = global_norm(grads)
        clip = norm >= opt.max_norm
        grads = torch._foreach_div(grads, torch.where(clip, norm, torch.ones_like(norm)))
        torch._foreach_mul_(grads, torch.where(clip, torch.full_like(norm, opt.max_norm),
                                               torch.ones_like(norm)))
        torch._foreach_mul_(mus, opt.b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - opt.b1))
        torch._foreach_mul_(nus, opt.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                    1.0 - opt.b2))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, opt.eps)
        update = torch._foreach_div(mus, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, schedule(opt.count))
        torch._foreach_sub_(params, update)
    opt.count += 1


def test_k1_update_is_the_plain_update_bit_for_bit():
    cfg, jcfg = _configs(**{"train.scheduler": "constant"})
    params = _jax_params(jcfg)
    models = [load_jax_params(MaDe(cfg), params, cfg) for _ in range(2)]
    opts = [make_optimizer(m, cfg, HORIZON) for m in models]
    assert opts[0].acc == {}
    for grads in _gradient_sequence(params, 4, seed=2):
        for m in models:
            _set_grads(m, grads, cfg)
        opts[0].step()
        _plain_update(opts[1])
    for (name, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), name
    state = [o.state_dict() for o in opts]
    assert state[0]["count"] == state[1]["count"] == 4 and state[0]["mini_step"] == 0
    for key in ("mu", "nu"):
        for name in state[0][key]:
            assert torch.equal(state[0][key][name], state[1][key][name]), (key, name)


@pytest.mark.kernel
def test_accumulating_train_step_matches_jax():
    """JAX's make_train_step under make_optimizer with k = 2 against the
    port's, dropout 0, four micro-steps of one example batch, the weights
    carried across.  Each micro-step's loss within rtol 1e-5 and the
    optimizer's micro-step count equal to JAX's state.step; after the first
    update (at warmup-cosine's lr(0) = 0) no weight has moved on either side.
    Every micro-step sees the first weights, so the second update is Adam's
    second step on twice the same mean gradient, lr(1) * g / (|g| + eps)
    with the horizon's lr(1) = 3e-4 (HORIZON / 2 updates, one of warmup; an
    undivided horizon would give 1.5e-4): parameters within atol 1e-5,
    rtol 1e-4, except where JAX's gradient lies within the gradient
    tolerance of zero, whose sign either framework may take (2 lr(1)
    there, as test_torch_port_train.py::_assert_update)."""
    cfg, jcfg = _configs(**NO_DROPOUT, **{"train.gradient_accumulation_steps": 2})
    batch = example_batch(np.random.RandomState(0), cfg, BATCH)
    params = _jax_params(jcfg)
    jmodel = JaxMaDe(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)

    def loss_fn(p):
        out = jmodel.apply(p, jb["frame_feats"], jb["frame_mask"], jb["segment_feats"],
                           jb["segment_mask"], v_duration=jb["v_duration"],
                           deterministic=False, rngs={"dropout": key})
        return jax_total_loss(out, jb["spans_target"], jcfg)[0]

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    tx = jax_make_optimizer(jcfg, HORIZON)
    state = create_state(jmodel, jcfg, tx, jax.random.PRNGKey(0), jb)
    state = state.replace(params=params, opt_state=tx.init(params))
    jstep = jax_make_train_step(jmodel, jcfg)

    model = load_jax_params(MaDe(cfg), params, cfg)
    opt = make_optimizer(model, cfg, HORIZON)
    step = make_train_step(model, cfg, opt)
    tb = to_tensors(batch, "cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for micro in range(4):
        state, jlog = jstep(state, jb, key)
        log = step(tb)
        np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]), rtol=1e-5,
                                   err_msg=f"micro-step {micro}")
        np.testing.assert_allclose(float(log["grad_norm"]), float(jlog["grad_norm"]),
                                   rtol=1e-4, err_msg=f"micro-step {micro}")
        assert opt.micro_step == int(state.step) == micro + 1
        if micro == 1:
            for name, p in model.named_parameters():
                assert torch.equal(p, start[name]), name
            _assert_state(model, state.params, cfg, atol=0, rtol=0, what="first update")
    assert opt.count == 2
    lr = make_schedule(cfg.train.scheduler, cfg.train.matching_lr,
                       int(HORIZON // 2 * cfg.train.warmup_rate), HORIZON // 2)(1)
    assert lr == np.float32(cfg.train.matching_lr)
    want = jax_tree_to_state_dict(jax.device_get(state.params), cfg)
    g = jax_tree_to_state_dict(grads, cfg)
    frozen = {n for n, _ in param_groups(model)[FROZEN]}
    moved = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if name in frozen:
            np.testing.assert_array_equal(got, start[name].numpy(), err_msg=name)
            continue
        near_zero = np.abs(g[name]) <= 1e-5 + 1e-4 * np.abs(g[name])
        tol = np.where(near_zero, 2 * lr, 0.0) + 1e-5 + 1e-4 * np.abs(want[name])
        err = np.abs(got - want[name])
        assert (err <= tol).all(), f"{name}: max error {err.max()}"
        moved += int((np.abs(want[name] - start[name].numpy()) > lr / 2).sum())
    assert moved > 0


def test_dropout_is_keyed_on_the_micro_step():
    """With dropout on and k = 2, the two micro-steps of one update see the
    same weights and batch but draw different masks (JAX folds state.step,
    which counts micro-batches, into the step's rng), and a rerun repeats
    both losses."""
    cfg = Config.from_overrides({**TINY, "train.gradient_accumulation_steps": 2})
    batch = to_tensors(example_batch(np.random.RandomState(1), cfg, BATCH), "cpu")
    runs = []
    for _ in range(2):
        model = MaDe(cfg, torch.Generator().manual_seed(0))
        opt = make_optimizer(model, cfg, HORIZON)
        step = make_train_step(model, cfg, opt)
        runs.append([float(step(batch)["loss"]) for _ in range(2)])
        assert (opt.count, opt.mini_step) == (1, 0)
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = Config.from_overrides(TINY)
    root = str(tmp_path_factory.mktemp("data"))
    synthetic.generate(root, n_rows=48, n_unique_music=24, data_cfg=cfg.data, seed=0)
    return synthetic.open_synthetic(root, cfg.data)


def _trainer_cfg(tmp_path, name, **train):
    cfg = Config.from_overrides({**TINY, "model.temporal_dropout": 0.1,
                                 "train.batch_size_train": 16, "train.batch_size_val": 16,
                                 "train.gradient_accumulation_steps": 2})
    return cfg.replace(train=dataclasses.replace(cfg.train, output_dir=str(tmp_path / name),
                                                 **train))


def _final_state(trainer):
    opt = trainer.optimizer.state_dict()
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in opt["mu"].items()},
            {k: v.clone() for k, v in opt["nu"].items()},
            {k: v.clone() for k, v in opt["acc_grads"].items()},
            (opt["count"], opt["mini_step"], opt["gradient_step"]))


@pytest.mark.parametrize("abort_at", [3, 5])
def test_preemption_mid_accumulation_resumes_bit_identical(tmp_path, data, abort_at):
    """k = 2, 3 micro-batches an epoch, 2 epochs (3 updates, the second
    spanning the epoch boundary), a 'last' save every micro-batch, killed
    with one gradient in the accumulator (micro-step 3: the end of epoch 1;
    micro-step 5: epoch 2's second), resumed from 'last': weights, Adam's
    moments, the accumulator and the counts, and the epoch records equal an
    uninterrupted run's exactly; Trainer.step counts micro-batches."""
    full = Trainer(_trainer_cfg(tmp_path, "full", epochs=2), train_data=data, val_data=data,
                   device="cpu")
    want = full.fit()
    assert full.step == 6 and full.optimizer.count == 3
    assert full.ckpt.restore("last")["step"] == 6
    cfg = _trainer_cfg(tmp_path, f"pre{abort_at}", epochs=2, checkpoint_every_steps=1,
                       abort_at_step=abort_at)
    first = Trainer(cfg, train_data=data, val_data=data, device="cpu")
    with pytest.raises(Preempted, match="injected preemption"):
        first.fit()
    saved = first.ckpt.restore("last")
    assert saved["step"] == abort_at
    assert (saved["opt_state"]["mini_step"], saved["opt_state"]["count"]) == (1, abort_at // 2)
    assert any(v.abs().sum() > 0 for v in saved["opt_state"]["acc_grads"].values())
    resumed = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, resume="last",
                                                            abort_at_step=0)),
                      train_data=data, val_data=data, device="cpu")
    got = resumed.fit()
    assert [h["epoch"] for h in got["history"]] == [1, 2]
    for a, b in zip(_final_state(resumed), _final_state(full)):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert a == b
    for e in (0, 1):
        assert got["history"][e]["eval"] == want["history"][e]["eval"]
    # the epoch whose steps all ran in one process: after a kill at the end
    # of epoch 1 its record is an evaluation replay; after one in epoch 2,
    # epoch 2's statistics cover the resumed steps only
    whole = 1 if abort_at == 3 else 0
    assert got["history"][whole]["train"] == {
        **want["history"][whole]["train"], "seconds": got["history"][whole]["train"]["seconds"],
        "clips_per_sec": got["history"][whole]["train"]["clips_per_sec"]}
