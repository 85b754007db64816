"""JAX's whole training state carried into the port, on the CPU at the
small widths of tests/test_torch_port_trainer.py (vit 64, ast 96, D=32),
float32, every dropout rate 0.

- Held steps (scripts/ab_port_vs_jax.py::held_steps): at each of 12 steps
  of JAX's Trainer (constant schedule, so every update moves the weights
  and Adam's moments are non-zero), JAX's weights and optimizer state
  moved into a port Trainer (interop/from_jax.py::load_jax_params and
  jax_opt_state_to_port) and one port step on JAX's batch: the loss within
  1e-5, the gradients within tests/test_torch_port_train.py's tolerances,
  the update by its rule (test_torch_port_train.py::_assert_update); a
  step may hold once one ReLU gate within 1e-6 of zero is turned, as the
  A/B allows (scripts/ab_port_vs_jax.py::hold_step; none was here).  At
  gradient_accumulation_steps 1 and 2 (a MultiStepsState mid-accumulation
  every other step, its running mean held too) and with the EmbeddingNet
  aggregator (its batch_stats and running buffers held too).
- jax_opt_state_to_port: optax's update continued in the port from the
  converted state equals optax's; doctored states raise (the groups'
  counts differ, a leaf owned by no group, a leaf owned twice, moments of
  a frozen leaf, an accumulation the configuration does not run), and an
  entry of the key map that is no re-layout is refused.
- scripts/convert_jax_run.py: a JAX run preempted in its second epoch
  leaves a step-granular `last` and epoch 1's boundary save as
  `last.prev`; every tag is converted, and the port's Trainer.fit resumes
  from each of the two.
  Its next steps' losses agree with JAX's own resumed run within 1e-5
  relative, and its history.json continues JAX's (the earlier records as
  JAX wrote them), at gradient_accumulation_steps 1 and 2.
- The committed fixture of chip_smoke.py's [jax-resume] phase
  (tests/fixtures/jax_run, from `convert_jax_run.py --make-fixture`)
  resumed by the port's cli.train on the CPU within 1e-5 of the losses JAX
  recorded beside it, so the fixture cannot go stale unseen.
"""

import copy
import json
import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import ab_port_vs_jax as ab  # noqa: E402
import convert_jax_run  # noqa: E402
from mgsv_tpu.config import Config as JaxConfig  # noqa: E402
from mgsv_tpu.core.mesh import make_mesh as jax_make_mesh  # noqa: E402
from mgsv_tpu.data.synthetic import open_synthetic as jax_open_synthetic  # noqa: E402
from mgsv_tpu.models.made import MaDe as JaxMaDe  # noqa: E402
from mgsv_tpu.train.loop import Preempted as JaxPreempted, Trainer as JaxTrainer  # noqa: E402
from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer  # noqa: E402
from mgsv_tpu_torch.cli import train as train_cli  # noqa: E402
from mgsv_tpu_torch.cli.overrides import overrides_to_args  # noqa: E402
from mgsv_tpu_torch.config import Config  # noqa: E402
from mgsv_tpu_torch.core.checkpoint import CheckpointManager  # noqa: E402
from mgsv_tpu_torch.data import synthetic  # noqa: E402
from mgsv_tpu_torch.interop import from_jax  # noqa: E402
from mgsv_tpu_torch.interop.from_jax import (jax_opt_state_to_port,  # noqa: E402
                                             jax_variables_to_state_dict, load_jax_params)
from mgsv_tpu_torch.models.made import MaDe  # noqa: E402
from mgsv_tpu_torch.train import loop as port_loop  # noqa: E402
from mgsv_tpu_torch.train.loop import Trainer  # noqa: E402
from mgsv_tpu_torch.train.optimizer import make_optimizer  # noqa: E402

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32", **ab.NO_DROPOUT}
RTOL = 1e-5
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_run")


def _one_device_mesh():
    return jax_make_mesh((1, 1), [jax.devices()[0]])


# ------------------------------------------------------------- held steps
@pytest.mark.parametrize("extra", [{}, {"train.gradient_accumulation_steps": 2},
                                   {"model.agg_module": "mlp"}], ids=["k1", "k2", "mlp"])
def test_held_steps_from_jax_state(tmp_path, extra):
    over = {**TINY, "train.batch_size_train": 8, "train.batch_size_val": 8, "train.epochs": 1,
            "train.save_checkpoints": False, "train.seed": 42, "train.scheduler": "constant",
            **extra}
    cfg, jcfg = ab.configs(over)
    root = str(tmp_path / "data")
    synthetic.generate(root, n_rows=96, n_unique_music=48, data_cfg=cfg.data, seed=0)
    jt, pt = ab.paired_trainers(cfg, jcfg, root, str(tmp_path), jax_device=jax.devices()[0])
    held = Trainer(cfg, pt.train_data, None, run_dir=str(tmp_path / "held"), device="cpu")
    held.init_state()
    recs = ab.held_steps(jt, held, cfg, jcfg)
    jt.train_epoch(1)
    assert [r["step"] for r in recs] == list(range(1, 13))
    for r in recs:        # as the A/B holds them: at most one gate at rounding distance turned
        assert ab.held_ok(r) and len(r.get("gates_turned", [])) <= 1, r
    k = cfg.train.gradient_accumulation_steps
    updates = [r for r in recs if r["mini_step"] == k - 1]
    assert len(updates) == 12 // k and all(max(r["lr"].values()) > 0 for r in updates)
    if k > 1:     # the mid-accumulation steps held their running mean, moving nothing
        mid = [r for r in recs if r["mini_step"] < k - 1]
        assert mid and all("acc_max_err" in r and r["update_max_err"] == 0.0 for r in mid)
    if cfg.model.agg_module == "mlp":
        assert all("buffers_max_err" in r for r in recs)


# -------------------------------------------------- jax_opt_state_to_port
def _adam_states(overrides, updates=3, seed=0):
    """JAX variables, optax's state after `updates` updates from seeded
    gradients, the (jitted) update and the generator, for TINY +
    overrides."""
    jcfg = JaxConfig.from_overrides({**TINY, "train.scheduler": "constant", **overrides})
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.device_get(jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0)))
    tx = jax_make_optimizer(jcfg, 100, train_query_embed=jcfg.train.train_query_embed)
    update = jax.jit(tx.update)
    state, rng = tx.init(params), np.random.default_rng(seed)
    for _ in range(updates):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
                             params)
        upd, state = update(grads, state, params)
        params = optax.apply_updates(params, upd)
    return params, state, update, rng


@pytest.fixture(scope="module")
def flat_states():
    """{k: optax's state after 3 updates, as opt_state_to_numpy's trees}."""
    return {k: convert_jax_run.opt_state_to_numpy(
        _adam_states({"train.gradient_accumulation_steps": k})[1]) for k in (1, 2)}


@pytest.mark.parametrize("overrides", [
    {}, {"train.gradient_accumulation_steps": 2, "model.agg_module": "mlp"},
    {"train.train_query_embed": True, "model.with_cls_token": True, "model.mml_fusion": "CA"}],
    ids=["k1", "k2-mlp", "query-cls-ca"])
def test_continued_adam_equals_optax(overrides):
    """Three more updates from seeded gradients: optax on JAX's state, the
    port's GroupedAdam on the converted state (atol 1e-6, rtol 1e-5 as
    test_torch_port_train.py holds the optimizer)."""
    cfg = Config.from_overrides({**TINY, "train.scheduler": "constant", **overrides})
    params, state, update, rng = _adam_states(overrides)
    model = load_jax_params(MaDe(cfg), params, cfg)
    opt = make_optimizer(model, cfg, 100)
    opt.load_state_dict(jax_opt_state_to_port(convert_jax_run.opt_state_to_numpy(state), cfg))
    assert opt.micro_step == 3
    names = {id(p): n for n, p in model.named_parameters()}
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
                             params)
        upd, state = update(grads, state, params)
        params = optax.apply_updates(params, upd)
        port_grads = jax_variables_to_state_dict({"params": grads["params"]}, cfg)
        for p in model.parameters():
            p.grad = torch.from_numpy(np.array(port_grads[names[id(p)]]))
        opt.step()
        want = jax_variables_to_state_dict(params, cfg)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=1e-5,
                                       err_msg=name)


def _doctor(flat, case):
    if case == "counts":
        flat["count"]["matching"] += 1
    elif case == "missing":
        for key in ("mu", "nu"):
            flat[key]["temporal"]["params"]["video_tower"]["proj"]["kernel"] = None
    elif case == "twice":
        for key in ("mu", "nu"):
            flat[key]["matching"]["params"]["video_tower"] = copy.deepcopy(
                flat[key]["temporal"]["params"]["video_tower"])
    elif case == "frozen":
        for key in ("mu", "nu"):
            flat[key]["detection"]["params"]["query_embed"] = np.zeros((1, 32), np.float32)
    elif case == "accumulation":
        del flat["acc_grads"], flat["mini_step"], flat["gradient_step"]
    elif case == "gradient_step":
        flat["gradient_step"] += 1
    return flat


@pytest.mark.parametrize("case,match", [
    ("counts", "counts differ"), ("missing", "owned by no group"), ("twice", "owned twice"),
    ("frozen", "frozen in the port"), ("accumulation", "gradient_accumulation_steps"),
    ("gradient_step", "gradient_step")])
def test_doctored_state_raises(flat_states, case, match):
    cfg = Config.from_overrides({**TINY, "train.scheduler": "constant",
                                 "train.gradient_accumulation_steps": 2})
    flat = copy.deepcopy(flat_states[2])
    jax_opt_state_to_port(flat, cfg)                         # the state as it is converts
    with pytest.raises(ValueError, match=match):
        jax_opt_state_to_port(_doctor(flat, case), cfg)


def test_a_key_map_entry_that_is_no_relayout_is_refused(flat_states):
    """Were the port to keep logit_scale in another parametrisation (its
    log, say), the key map's entry would change values, not move them:
    Adam's moments cannot be carried through it, and the conversion
    raises for that entry rather than convert it."""
    cfg = Config.from_overrides({**TINY, "train.scheduler": "constant"})
    flat = flat_states[1]
    real = from_jax.jax_variables_to_state_dict

    def reparametrised(tree, cfg):
        out = real(tree, cfg)
        out["logit_scale"] = np.log1p(np.abs(out["logit_scale"]))
        return out

    with mock.patch.object(from_jax, "jax_variables_to_state_dict", reparametrised):
        with pytest.raises(ValueError, match="logit_scale is not a re-layout"):
            jax_opt_state_to_port(flat, cfg)


# ----------------------------------------------------------------- resume
RUN_ROWS, RUN_BS, RUN_EPOCHS, EVERY, ABORT = 48, 16, 3, 2, 5
PER_EPOCH = RUN_ROWS // RUN_BS
# the preempted run's resume points: its periodic save after global step 5
# (epoch 2, step 2) and, one save older, epoch 1's boundary save
CASES = {"mid": "last", "boundary": "last.prev"}


def _run_overrides(k):
    return {**TINY, "train.batch_size_train": RUN_BS, "train.batch_size_val": RUN_BS,
            "train.epochs": RUN_EPOCHS, "train.checkpoint_every_steps": EVERY,
            "train.gradient_accumulation_steps": k}


def _jax_fit(jcfg, data, run_dir):
    """JAX's Trainer.fit on one device, its step losses recorded; a
    preemption ends it.  Each save is waited for: orbax writes
    asynchronously, and JAX's `last` rotation only sees a committed save."""
    jt = JaxTrainer(jcfg, data, data, mesh=_one_device_mesh(), run_dir=run_dir)
    losses, step, save = [], jt.train_step, jt.ckpt.save

    def train_step(state, batch, rng):
        state, log = step(state, batch, rng)
        losses.append(float(log["loss"]))
        return state, log

    def save_and_wait(tag, state):
        path = save(tag, state)
        jt.ckpt.wait()
        return path

    jt.train_step, jt.ckpt.save = train_step, save_and_wait
    try:
        jt.fit()
    except JaxPreempted:
        pass
    jt.ckpt.wait()
    return losses


def _as_last(run_dir, tag, dest):
    """A copy of run_dir whose resume point `last` is the tag `tag`."""
    shutil.copytree(run_dir, dest)
    if tag != "last":
        shutil.rmtree(os.path.join(dest, "ckpt_last"))
        os.rename(os.path.join(dest, f"ckpt_{tag}"), os.path.join(dest, "ckpt_last"))
    return dest


@pytest.fixture(scope="module", params=[1, 2], ids=["k1", "k2"])
def resumed(request, tmp_path_factory):
    """A JAX run preempted after step ABORT and converted; then JAX and the
    port resumed from each resume point of CASES."""
    k = request.param
    tmp = tmp_path_factory.mktemp(f"resume_k{k}")
    over = _run_overrides(k)
    cfg, jcfg = ab.configs(over)
    root = str(tmp / "data")
    synthetic.generate(root, n_rows=RUN_ROWS, data_cfg=cfg.data)   # what --synthetic writes
    jdata = jax_open_synthetic(root, jcfg.data)
    pdata = synthetic.open_synthetic(root, cfg.data)
    jax_run, port_run = str(tmp / "jax"), str(tmp / "port")
    first = _jax_fit(JaxConfig.from_overrides({**over, "train.abort_at_step": ABORT}), jdata,
                     jax_run)
    tags = convert_jax_run.convert_run(jax_run, port_run, over)
    mgr = CheckpointManager(port_run)
    converted = {tag: mgr.restore(tag) for tag in tags}
    resume = {**over, "train.resume": "last"}
    runs = {}
    for case, tag in CASES.items():
        jdir = _as_last(jax_run, tag, str(tmp / f"jax_{case}"))
        pdir = _as_last(port_run, tag, str(tmp / f"port_{case}"))
        jax_losses = _jax_fit(JaxConfig.from_overrides(resume), jdata, jdir)
        pt = Trainer(Config.from_overrides(resume), pdata, pdata, run_dir=pdir, device="cpu")
        pt.init_state()
        port_losses = ab.recording(pt)
        pt.fit()
        runs[case] = {"jax": jax_losses, "port": [float(x) for x in port_losses],
                      "jax_history": json.load(open(os.path.join(jdir, "history.json"))),
                      "port_history": json.load(open(os.path.join(pdir, "history.json"))),
                      "resumed_from": converted[tag],
                      "saved": CheckpointManager(pdir).restore("last")}
    return {"k": k, "first": first, "tags": tags, "converted": converted, "runs": runs,
            "jax_run": jax_run}


@pytest.mark.parametrize("case", list(CASES))
def test_port_resume_matches_jax_resume(resumed, case):
    """The port's Trainer.fit from the converted resume point takes JAX's
    resumed run's steps, each loss within 1e-5, and ends where JAX's ends."""
    run, k = resumed["runs"][case], resumed["k"]
    done = run["resumed_from"]["step"]
    assert len(run["jax"]) == len(run["port"]) == PER_EPOCH * RUN_EPOCHS - done
    np.testing.assert_allclose(run["port"], run["jax"], rtol=RTOL)
    saved = run["saved"]
    assert saved["step"] == PER_EPOCH * RUN_EPOCHS
    assert saved["opt_state"]["count"] == PER_EPOCH * RUN_EPOCHS // k


def test_converted_tags(resumed):
    """Every tag of the JAX run converted: the resume points with the
    optimizer state and their counters (`last` a step-granular save
    mid-epoch, at k = 2 mid-accumulation too; `last.prev` epoch 1's
    boundary save), the best-metric tags with the weights alone."""
    conv, k = resumed["converted"], resumed["k"]
    assert {"last", "last.prev", "best_r1"} <= set(resumed["tags"]) == set(conv)
    assert len(resumed["first"]) == ABORT
    last, prev = conv["last"], conv["last.prev"]
    assert (last["epoch"], last["step_in_epoch"], last["step"]) == (2, ABORT - PER_EPOCH, ABORT)
    assert (prev["epoch"], prev["step"], "step_in_epoch" in prev) == (1, PER_EPOCH, False)
    for point in (last, prev):
        opt = point["opt_state"]
        assert (opt["count"], opt["mini_step"]) == divmod(point["step"], k)
    best = conv["best_r1"]
    assert "opt_state" not in best and best["params"].keys() == last["params"].keys()


def test_history_continues_jax(resumed):
    """The resumed port run's history.json keeps the records JAX wrote
    before the resume point as JAX wrote them, and continues with JAX's
    epochs, each epoch's training loss within 1e-5 of JAX's resumed run."""
    for case, run in resumed["runs"].items():
        jh, ph = run["jax_history"], run["port_history"]
        assert [r["epoch"] for r in ph] == [r["epoch"] for r in jh] == list(
            range(1, RUN_EPOCHS + 1)), case
        assert ph[0] == jh[0], case              # epoch 1: JAX's own record, copied
        for j, p in zip(jh[1:], ph[1:]):
            assert p["train"]["steps"] == j["train"]["steps"], case
            np.testing.assert_allclose(p["train"]["loss"], j["train"]["loss"], rtol=RTOL)


def test_convert_refuses_what_the_trainer_refuses(resumed, tmp_path):
    """A configuration the port's MaDe refuses, and one whose widths are
    not the run's, convert nothing."""
    over = _run_overrides(resumed["k"])
    jax_run = resumed["jax_run"]
    bad = {**over, "model.vmr_fusion": "NO", "model.moment_query_type": "xpool"}
    with pytest.raises(ValueError, match="moment_query_type"):
        convert_jax_run.convert_run(jax_run, str(tmp_path / "a"), bad)
    with pytest.raises((RuntimeError, KeyError, ValueError)):
        convert_jax_run.convert_run(jax_run, str(tmp_path / "b"),
                                    {**over, "model.temporal_mlp_dim": 128})
    assert not os.path.exists(str(tmp_path / "a" / "ckpt_last"))


# ---------------------------------------------------------------- fixture
def test_fixture_resumes_within_1e5(tmp_path):
    """The [jax-resume] fixture through the port's cli.train on the CPU:
    every resumed step's loss and the continued history within 1e-5 of what
    JAX's own resumed run recorded beside it."""
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        want = json.load(f)
    out = str(tmp_path / "out")
    shutil.copytree(os.path.join(FIXTURE, "made"), os.path.join(out, "made"))
    losses, make = [], port_loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(batch):
            log = step(batch)
            losses.append(float(log["loss"]))
            return log
        return train_step

    with mock.patch.object(port_loop, "make_train_step", recording):
        train_cli.main(["--device", "cpu", "--synthetic", str(want["synthetic_rows"]),
                        *overrides_to_args(want["overrides"]),
                        "--train.output_dir", out, "--train.resume", "last"])
    assert len(losses) == len(want["resumed_losses"]) > 0
    np.testing.assert_allclose(losses, want["resumed_losses"], rtol=RTOL)
    with open(os.path.join(out, "made", "history.json")) as f:
        history = json.load(f)
    assert [r["epoch"] for r in history] == [r["epoch"] for r in want["resumed_history"]]
    for got, exp in zip(history, want["resumed_history"]):
        np.testing.assert_allclose(got["train"]["loss"], exp["train"]["loss"], rtol=RTOL)
