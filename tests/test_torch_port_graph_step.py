"""The training step replayed as CUDA graphs (train/graphs.py) and what it
rests on: the kernels' seeds in device memory (models/layers.py::StepSeeds,
ops/philox.py::device_seed) and Adam's per-step scalars in device memory
(train/optimizer.py::GroupedAdam.stage).

The tests without a mark run on the CPU: the scalars' update against
host-scalar Adam, bit for bit, across the warm-up/cosine boundary and a
state_dict round trip; the seed slots against draw_seed's offsets and the
benchmark reference's draws; where the graphs engage.  The `cuda` tests
run the graphed step against the eager one on the card, bit for bit, under
made_paper and made_q10 at B=64.  The file imports nothing of JAX:

    python3 -m pytest -m cuda tests/test_torch_port_graph_step.py -q
"""

import copy

import numpy as np
import pytest
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.core import profiling
from mgsv_tpu_torch.core.device import resolve_device, write_to_device
from mgsv_tpu_torch.data.example_batch import example_batch, to_tensors
from mgsv_tpu_torch.models import layers as L
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train import graphs
from mgsv_tpu_torch.train.optimizer import global_norm, make_optimizer
from mgsv_tpu_torch.train.schedule import make_schedule
from mgsv_tpu_torch.train.step import make_train_step, step_key
from portbench.reference import made as reference

TINY = {"data.max_v_frames": 12, "data.stride": 20.0, "data.filter_sec": 20.0,
        "data.vit_dim": 64, "data.ast_dim": 96, "model.dim_input": 32,
        "model.temporal_mlp_dim": 64, "model.detr_ffn_dim": 64, "model.detr_enc_layers": 1,
        "model.detr_dec_layers": 2, "model.contrastive_dim": 32, "model.video_pe_len": 40,
        "model.audio_pe_len": 40, "model.compute_dtype": "float32"}
HORIZON = 200          # warm-up: int(200 * 0.02) = 4 updates


# ------------------------------------------------------------------ Adam's scalars
def _host_scalar_adam(t, params_of, grads_of, count):
    """One update of GroupedAdam `t` as it was made with host scalars: the
    bias corrections from a Python exponent, the learning rate a Python
    float."""
    k = count + 1
    for group, schedule in t.schedules.items():
        named = t.groups[group]
        if not named:
            continue
        params, grads = params_of(named), grads_of(named)
        mus = [t.state[n][0] for n, _ in named]
        nus = [t.state[n][1] for n, _ in named]
        bc1, bc2 = (1.0 - torch.full((), b, dtype=torch.float32) ** k for b in (t.b1, t.b2))
        norm = global_norm(grads)
        clip = norm >= t.max_norm
        grads = torch._foreach_div(grads, torch.where(clip, norm, torch.ones_like(norm)))
        torch._foreach_mul_(grads, torch.where(clip, torch.full_like(norm, t.max_norm),
                                               torch.ones_like(norm)))
        torch._foreach_mul_(mus, t.b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - t.b1))
        torch._foreach_mul_(nus, t.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                    1.0 - t.b2))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, t.eps)
        update = torch._foreach_div(mus, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, schedule(count))
        torch._foreach_sub_(params, update)


def _grads(model, step):
    gen = torch.Generator().manual_seed(1000 + step)
    return {n: torch.randn(p.shape, generator=gen) * 0.3 for n, p in model.named_parameters()}


def _model(cfg):
    return MaDe(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("scheduler", ["warmupcosine", "warmuplinear"])
def test_device_scalars_update_equals_host_scalars_across_the_warmup(scheduler):
    cfg = Config.from_overrides({**TINY, "train.scheduler": scheduler})
    model, twin = _model(cfg), _model(cfg)
    opt, ref = make_optimizer(model, cfg, HORIZON), make_optimizer(twin, cfg, HORIZON)
    warmup = int(HORIZON * cfg.train.warmup_rate)
    lr = make_schedule(scheduler, cfg.train.matching_lr, warmup, HORIZON)
    for step in range(2 * warmup + 2):
        g = _grads(model, step)
        for n, p in model.named_parameters():
            p.grad = g[n].clone()
        opt.step()
        _host_scalar_adam(ref, lambda named: [p.detach() for _, p in named],
                          lambda named: [g[n].clone() for n, _ in named], step)
        k = step + 1
        assert opt.count == k
        want = [k, float(1 - torch.tensor(0.9, dtype=torch.float32) ** k),
                float(1 - torch.tensor(0.999, dtype=torch.float32) ** k)] + [lr(step)] * 3
        assert torch.equal(opt.scalars, torch.tensor(want, dtype=torch.float32)), step
        for (n, p), q in zip(model.named_parameters(), twin.parameters()):
            assert torch.equal(p, q), (step, n)
        for n in opt.state:
            assert torch.equal(opt.state[n][0], ref.state[n][0]), (step, n)
            assert torch.equal(opt.state[n][1], ref.state[n][1]), (step, n)


def test_state_dict_round_trip_refreshes_the_scalars():
    """Three updates, a state_dict into a fresh optimizer, three more: the
    weights, moments and scalars of six unbroken updates, bit for bit."""
    cfg = Config.from_overrides(TINY)
    runs = []
    for split in (None, 3):
        model = _model(cfg)
        opt = make_optimizer(model, cfg, HORIZON)
        for step in range(6):
            if step == split:
                state = copy.deepcopy(opt.state_dict())
                opt = make_optimizer(model, cfg, HORIZON)
                opt.stage()                             # scalars of update 0, then replaced
                opt.load_state_dict(state)
            g = _grads(model, step)
            for n, p in model.named_parameters():
                p.grad = g[n]
            opt.step()
        runs.append((model, opt))
    (a, oa), (b, ob) = runs
    assert torch.equal(oa.scalars, ob.scalars) and oa.count == ob.count == 6
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    for n in oa.state:
        assert all(torch.equal(x, y) for x, y in zip(oa.state[n], ob.state[n]))


def test_write_to_device_fills_the_front_of_a_buffer():
    buf = torch.zeros(5, dtype=torch.int32)
    write_to_device(buf, [7, -3, 2 ** 31 - 1])
    assert buf.tolist() == [7, -3, 2 ** 31 - 1, 0, 0]


# ------------------------------------------------------------------ kernel seeds
class _OffsetGenerator:
    """A CUDA generator's host state (seed, Philox offset), on any machine."""
    device = torch.device("cuda")

    def __init__(self, seed):
        self.seed, self.offset = seed, 0

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        self.offset = offset


@pytest.mark.parametrize("key", [0, 42, step_key(42, 7), step_key(2 ** 31 + 5, 3, 1)])
def test_seed_slots_hold_draw_seeds_seeds_and_replay_from_their_offsets(key):
    seeds = L.StepSeeds(torch.device("cpu"))
    gen, twin = _OffsetGenerator(key), _OffsetGenerator(key)
    slots, want = [], []
    with seeds.drawing():
        for plain in (0, 8, 0, 120, 4):         # plain dropout between the kernel calls
            gen.offset += plain
            twin.offset += plain
            slots.append(L.draw_seed(gen))
            want.append(reference.draw_seed(twin))     # the benchmark's reference draws
    assert [int(s) for s in slots] == want
    assert seeds.offsets == [0, 12, 16, 140, 148] and gen.offset == twin.offset == 152
    assert [L.seed_at(key, o) for o in seeds.offsets] == want
    assert all(s.data_ptr() == seeds.buffer[i:].data_ptr() for i, s in enumerate(slots))
    replay = L.StepSeeds(torch.device("cpu"))
    replay.write(key, seeds.offsets)
    assert torch.equal(replay.buffer, seeds.buffer)
    with seeds.drawing():                         # a new step starts at slot 0
        assert L.draw_seed(gen).data_ptr() == seeds.buffer.data_ptr()
    assert getattr(L._drawing, "seeds", None) is None


def test_a_cpu_generator_still_draws_int_seeds():
    gen = torch.Generator().manual_seed(5)
    want = int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.Generator().manual_seed(5)))
    with L.StepSeeds(torch.device("cpu")).drawing():
        assert L.draw_seed(gen) == want


# ------------------------------------------------------------------ where graphs engage
def test_graphs_engage_on_one_cuda_device_at_one_micro_batch_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.engages(cuda, None, 1)
    assert not graphs.engages(cuda, object(), 1)      # a mesh: NCCL in the step
    assert not graphs.engages(cuda, None, 2)          # accumulation
    assert not graphs.engages(cpu, None, 1)


@pytest.mark.parametrize("k", [1, 2])
def test_the_step_stays_eager_on_the_cpu(k):
    cfg = Config.from_overrides({**TINY, "train.gradient_accumulation_steps": k})
    model = _model(cfg)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, HORIZON))
    batch = to_tensors(example_batch(np.random.RandomState(0), cfg, 8), "cpu")
    profiling.clear_spans()
    for _ in range(3):
        step(batch)
    assert not profiling.span_records("step.replay")
    assert [r.step for r in profiling.span_records("step")] == [0, 1, 2]
    for name in ("step.forward", "step.loss", "step.backward", "step.optimizer"):
        assert len(profiling.span_records(name)) == 3, name


# ------------------------------------------------------------------ on the card
CONFIGS = {"made_paper": {},
           "made_q10": {"model.fused_temporal": True, "model.num_moment_queries": 10}}
B = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs and the kernels have no CPU mode")
    return resolve_device("cuda")


def _arm(cfg, dev, cuda_graphs):
    model = _model(cfg).to(dev)
    opt = make_optimizer(model, cfg, HORIZON)
    return model, opt, make_train_step(model, cfg, opt, cuda_graphs=cuda_graphs)


def _counts():
    return {fn: fn.launches for fn in graphs.kernel_counters()}


def _run(step, batch, strict=False):
    """step(batch) and each kernel wrapper's launches it counted; strict:
    under torch.cuda.set_sync_debug_mode("error")."""
    before = _counts()
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        log = step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return log, {fn.__name__: fn.launches - n for fn, n in before.items() if fn.launches != n}


def _assert_same(a, b, logs, what):
    (ma, oa), (mb, ob) = a, b
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), f"{what}: weight {n}"
        if n in oa.state:
            assert torch.equal(p.grad, q.grad) if p.grad is not None else q.grad is None, n
            assert torch.equal(oa.state[n][0], ob.state[n][0]), f"{what}: mu {n}"
            assert torch.equal(oa.state[n][1], ob.state[n][1]), f"{what}: nu {n}"
    assert oa.count == ob.count
    (la, ca), (lb, cb) = logs
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), f"{what}: log {k}"
    assert ca == cb and ca, f"{what}: launches {ca} vs {cb}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_steps_equal_eager_steps_bit_for_bit(dev, name):
    """Six steps at B=64 eager and graphed from the same weights, then a
    batch of B=48 (eager, then captured), B=64 again (the first graph,
    replayed), B=32 (a third set of shapes: eager)."""
    cfg = Config.from_overrides({**CONFIGS[name], "train.batch_size_train": B})
    model_e, opt_e, eager = _arm(cfg, dev, cuda_graphs=False)
    model_g, opt_g, graphed = _arm(cfg, dev, cuda_graphs=True)
    profiling.clear_spans()
    logs_g = []
    sizes = [B] * 6 + [48, 48, B, 32]
    for i, b in enumerate(sizes):
        batch = to_tensors(example_batch(np.random.RandomState(i), cfg, b), dev)
        got_e = _run(eager, batch)
        # from the third call of a set of shapes on, a replay: no host sync
        strict = i >= 2 and sizes[:i].count(b) >= 2 and b != 32
        got_g = _run(graphed, batch, strict=strict)
        logs_g.append(got_g[0])
        _assert_same((model_e, opt_e), (model_g, opt_g), (got_e, got_g), f"step {i} (B={b})")
    replayed = {r.step for r in profiling.span_records("step.replay")}
    assert replayed == {2, 3, 4, 5, 8}          # not the captures (1, 7) nor eager calls
    # each step's log is its own: steps apart differ
    assert len({float(log["loss"]) for log in logs_g}) == len(sizes)
