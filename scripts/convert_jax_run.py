"""Convert a run of the JAX package's Trainer into one the port's Trainer resumes.

    python scripts/convert_jax_run.py --jax-run RUN/made --out PORT/made \
        [--tags last,best_r1] [--section.key value ...]
    python scripts/convert_jax_run.py --make-fixture tests/fixtures/jax_run

Runs where both packages are installed (the CPU is enough); the card needs
only what it writes.  Each checkpoint tag of the JAX run directory (every
`ckpt_<tag>` by default) is read through JAX's own
`CheckpointManager.restore` and written as the port's `ckpt_<tag>/state.pt`:

- `last` and `last.prev` (the resume points) carry the weights, the
  optimizer state and the step counters, in the layout of the port's
  `Trainer._snapshot`: `params` (a port state dict, running buffers
  included), `opt_state` (`GroupedAdam.state_dict`'s form), `step`,
  `epoch` and, for a step-granular save, `step_in_epoch`.  orbax restores
  optax's state untyped; it is rebuilt against
  `make_optimizer(...).init(params)` by the JAX Trainer's own
  `_retype_like` (a plain unflatten would reassign MultiStepsState's
  slots), flattened into numpy trees here (`opt_state_to_numpy`) and
  carried across by `mgsv_tpu_torch.interop.from_jax.jax_opt_state_to_port`.
- `best_*` and `epoch_*` carry the weights, `step` and `epoch`.

`history.json` is copied, so the port's resume continues JAX's records and
replays an evaluation whose record never landed, as JAX's does.  The
`--section.key value` overrides must be the run's own: the configuration is
not stored with a JAX run.  A configuration the port's Trainer refuses is
refused here (the model is built, every tensor loaded strictly, and the
mesh shape checked for dp x mp ranks).  Then, on the card, with the same
overrides and the same data,

    python -m mgsv_tpu_torch.cli.train --train.resume last \
        --train.output_dir PORT/.. [--synthetic N] [--section.key value ...]

continues the run: the schedules' horizon comes from the run's micro-batch
count, and a step-granular `last` replays the rest of its epoch's seeded
batch stream, as JAX's resume does.

`--make-fixture DIR` writes the converted run that `chip_smoke.py`'s
[jax-resume] phase and tests/test_torch_port_jax_state.py resume:
`FIXTURE_OVERRIDES` (D=256, the width the kernels take, every other width
small; dropout off, float32) on FIXTURE_ROWS generated rows, trained by
JAX's `cli.train` until a preemption after FIXTURE_ABORT steps (a
step-granular `last` in epoch 2), converted into DIR/made, and JAX's own
resumed run's step losses and history in DIR/expected.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import optax
import torch

from mgsv_tpu_torch.cli.overrides import overrides_to_args, parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core.checkpoint import CheckpointManager
from mgsv_tpu_torch.core.device import check_mesh_shape
from mgsv_tpu_torch.interop.from_jax import jax_opt_state_to_port, jax_variables_to_state_dict
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.optimizer import make_optimizer

FIXTURE_ROWS = 48
FIXTURE_ABORT = 4           # micro-batches before the preemption: epoch 2, step 1 of 3
FIXTURE_OVERRIDES = {
    "data.max_v_frames": 4, "data.stride": 20.0, "data.filter_sec": 20.0,
    "data.vit_dim": 16, "data.ast_dim": 16, "model.temporal_depth": 0,
    "model.detr_enc_layers": 1, "model.detr_dec_layers": 1, "model.detr_ffn_dim": 256,
    "model.decoder_self_attn": False, "model.contrastive_dim": 16,
    "model.compute_dtype": "float32", "model.temporal_dropout": 0.0,
    "model.xpool_dropout": 0.0, "model.detr_dropout": 0.0,
    "train.batch_size_train": 16, "train.batch_size_val": 16, "train.epochs": 3,
    "train.checkpoint_every_steps": 1,
}


def _plain(tree) -> Any:
    """An optax tree -> nested dicts of numpy arrays, MaskedNode -> None."""
    if isinstance(tree, optax.MaskedNode):
        return None
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _find(state, kind):
    """The states of type `kind` inside an optax state, depth first."""
    if isinstance(state, kind):
        return [state]
    if isinstance(state, tuple):           # namedtuple states and chains
        return [s for sub in state for s in _find(sub, kind)]
    return []


def opt_state_to_numpy(opt_state) -> Dict[str, Any]:
    """The state of mgsv_tpu.train.optimizer.make_optimizer (optax objects)
    -> the plain numpy trees `jax_opt_state_to_port` takes: per group with
    Adam moments (temporal, matching, detection) its ScaleByAdamState's
    count, mu and nu (None where optax's MaskedNode stands: the leaf is
    another group's); the frozen group holds none.  A MultiStepsState
    (gradient_accumulation_steps > 1) adds mini_step, gradient_step and
    acc_grads.  Raises where a group's schedule count is not its Adam
    count."""
    out: Dict[str, Any] = {}
    if isinstance(opt_state, optax.MultiStepsState):
        out.update(mini_step=int(opt_state.mini_step),
                   gradient_step=int(opt_state.gradient_step),
                   acc_grads=_plain(opt_state.acc_grads))
        opt_state = opt_state.inner_opt_state
    count, mu, nu = {}, {}, {}
    for group, masked in opt_state.inner_states.items():
        adam = _find(masked.inner_state, optax.ScaleByAdamState)
        if not adam:
            continue                        # the frozen group: set_to_zero
        (adam,) = adam
        (schedule,) = _find(masked.inner_state, optax.ScaleByScheduleState)
        if int(schedule.count) != int(adam.count):
            raise ValueError(f"group {group}: schedule count {int(schedule.count)}, "
                             f"Adam count {int(adam.count)}")
        count[group], mu[group], nu[group] = int(adam.count), _plain(adam.mu), _plain(adam.nu)
    out.update(count=count, mu=mu, nu=nu)
    return out


def check_port_config(cfg: Config) -> MaDe:
    """Refuse what the port's Trainer refuses: the model's configuration
    (MaDe raises) and a mesh shape that is no run of dp x mp ranks; returns
    the model (on the CPU), for the strict loads."""
    dp, mp = (int(v) for v in cfg.train.mesh_shape)
    if min(dp, mp) >= 1:
        check_mesh_shape(cfg.train.mesh_shape, dp * mp)
    return MaDe(cfg)


def retyped_opt_state(restored_opt, params, jcfg):
    """orbax's untyped optimizer state -> optax's, by JAX's Trainer's rule
    (mgsv_tpu/train/loop.py::_retype_like against a fresh init)."""
    from mgsv_tpu.train.loop import _retype_like
    from mgsv_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    tx = jax_make_optimizer(jcfg, 1, train_query_embed=jcfg.train.train_query_embed)
    return _retype_like(tx.init(params), restored_opt)


def convert_tag(restored: dict, tag: str, cfg: Config, jcfg, model: MaDe) -> dict:
    """One restored JAX checkpoint -> the port's, checked by strict loads
    into `model` and into a fresh optimizer of it."""
    params = restored["params"]
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in jax_variables_to_state_dict(params, cfg).items()}
    model.load_state_dict(state, strict=True)
    out: Dict[str, Any] = {"params": state, "step": int(restored["step"]),
                           "epoch": int(restored["epoch"])}
    if "opt_state" in restored:
        opt = jax_opt_state_to_port(
            opt_state_to_numpy(retyped_opt_state(restored["opt_state"], params, jcfg)), cfg)
        optimizer = make_optimizer(model, cfg, 1)
        optimizer.load_state_dict(opt)
        if optimizer.micro_step != out["step"]:
            raise ValueError(f"checkpoint {tag}: step {out['step']}, but the optimizer "
                             f"state has applied {optimizer.micro_step} micro-batches")
        out["opt_state"] = opt
    if restored.get("step_in_epoch"):
        out["step_in_epoch"] = int(restored["step_in_epoch"])
    return out


def run_tags(run_dir: str) -> List[str]:
    """The checkpoint tags under a run directory (committed ones only)."""
    return sorted(d[len("ckpt_"):] for d in os.listdir(run_dir)
                  if d.startswith("ckpt_") and not d.endswith(".tmp")
                  and os.path.isdir(os.path.join(run_dir, d)))


def convert_run(jax_run: str, out: str, overrides: dict,
                tags: Optional[List[str]] = None) -> List[str]:
    """Convert `tags` (every tag by default) of the JAX run directory
    `jax_run` into the port's run directory `out`, and copy its
    history.json; returns the tags written."""
    from mgsv_tpu.config import Config as JaxConfig
    from mgsv_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
    cfg, jcfg = Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)
    model = check_port_config(cfg)
    tags = tags or run_tags(jax_run)
    jmgr, pmgr = JaxCheckpointManager(jax_run), CheckpointManager(out)
    for tag in tags:
        if not os.path.isdir(os.path.join(jax_run, f"ckpt_{tag}")):
            raise FileNotFoundError(f"no checkpoint {tag!r} under {jax_run}")
        converted = convert_tag(jmgr.restore(tag), tag, cfg, jcfg, model)
        pmgr.save(tag, converted)
    hist = os.path.join(jax_run, "history.json")
    if os.path.exists(hist):
        shutil.copyfile(hist, os.path.join(out, "history.json"))
    return tags


# ------------------------------------------------------------------ fixture
def recorded_jax_cli(argv: List[str]) -> list:
    """JAX's cli.train on `argv` with each step's loss recorded; returns the
    losses (a Preempted run returns those it took)."""
    from mgsv_tpu.cli import train as jax_train_cli
    from mgsv_tpu.train import loop as jax_loop
    losses, make = [], jax_loop.make_train_step

    def recording(model, cfg):
        step = make(model, cfg)

        def train_step(state, batch, rng):
            state, log = step(state, batch, rng)
            losses.append(float(log["loss"]))
            return state, log
        return train_step

    jax_loop.make_train_step = recording
    try:
        jax_train_cli.main(argv)
    except jax_loop.Preempted:
        pass
    finally:
        jax_loop.make_train_step = make
    return losses


def make_fixture(dest: str) -> dict:
    """Write the [jax-resume] fixture into `dest` (module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--platform", "cpu", "--synthetic", str(FIXTURE_ROWS),
                *overrides_to_args(FIXTURE_OVERRIDES)]
        first = recorded_jax_cli(base + ["--train.output_dir", os.path.join(tmp, "jax"),
                                         "--train.abort_at_step", str(FIXTURE_ABORT)])
        run = os.path.join(tmp, "jax", "made")
        if os.path.exists(os.path.join(dest, "made")):
            shutil.rmtree(os.path.join(dest, "made"))
        convert_run(run, os.path.join(dest, "made"), FIXTURE_OVERRIDES, ["last"])
        resumed = recorded_jax_cli(base + ["--train.output_dir", os.path.join(tmp, "jax"),
                                           "--train.resume", "last"])
        with open(os.path.join(run, "history.json")) as f:
            history = json.load(f)
    expected = {
        "command": "python scripts/convert_jax_run.py --make-fixture " + dest,
        "synthetic_rows": FIXTURE_ROWS, "overrides": FIXTURE_OVERRIDES,
        "steps_before": first, "resumed_losses": resumed, "resumed_history": history,
    }
    with open(os.path.join(dest, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
    return expected


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--jax-run", help="the JAX run directory (train.output_dir/train.name)")
    p.add_argument("--out", help="the port's run directory to write")
    p.add_argument("--tags", default=None, help="comma-separated tags (default: every tag)")
    p.add_argument("--make-fixture", default=None, metavar="DIR")
    a, rest = p.parse_known_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if a.make_fixture:
        expected = make_fixture(a.make_fixture)
        print(json.dumps({k: expected[k] for k in ("steps_before", "resumed_losses")}))
        return 0
    if not (a.jax_run and a.out):
        p.error("--jax-run and --out are required")
    tags = convert_run(a.jax_run, a.out, parse_kv_overrides(rest),
                       a.tags.split(",") if a.tags else None)
    print(json.dumps({"converted": tags, "out": os.path.abspath(a.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
