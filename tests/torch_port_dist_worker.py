"""One rank of the port's distributed checks (tests/test_torch_port_dist.py,
tests/test_torch_port_model_axis.py).

    python tests/torch_port_dist_worker.py SPEC_JSON RANK

joins a group of the spec's world size on the spec's device (gloo on the
CPU, NCCL where each rank has a card), makes the mesh of the spec's
`mesh_shape` (default: every rank on dp) and runs each of the spec's cases
on this rank's rows, writing `<out>/<case>.rank<RANK>.npz`; `launch`
starts the ranks and reads their results.  The same functions run a case in one
process (mesh None) for the tests' reference, and
`assert_close_to_one_process` holds a rank's step to it.  The module
imports nothing of JAX, so the `cuda` tests use it too.  Cases:

- step: `gradient_accumulation_steps` micro-batches of the given global
  batches from the given weights; the logs, the gradients of the last
  micro-batch, the parameters, running buffers and Adam moments after.
- dropout: one step at the configured dropout rates, recording the first
  plain dropout mask and every kernel seed drawn.
- evaluate: `evaluate` on a synthetic dataset (host or resident), and the
  corpus similarity of given inputs on the evaluation kernel, tracks split
  over the ranks or whole.
- resident: the epoch's batches of the dp-sharded resident tables and of
  the host pipeline, this rank's rows.
- similarity: the plain corpus similarity of given inputs over the mesh
  (`xpool_similarity_mesh`) and with the tracks split over dp
  (`xpool_similarity_sharded`), or blocked in one process.
- engine: `RetrievalEngine` queries with the index sharded over the
  spec's axis, or whole in one process, and the pair rows each rank
  localized.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mgsv_tpu_torch.config import Config  # noqa: E402
from mgsv_tpu_torch.core.mesh import Mesh, local_rows  # noqa: E402
from mgsv_tpu_torch.models import layers as L  # noqa: E402
from mgsv_tpu_torch.models.made import MaDe  # noqa: E402
from mgsv_tpu_torch.train.optimizer import make_optimizer  # noqa: E402
from mgsv_tpu_torch.train.step import make_train_step  # noqa: E402

HORIZON = 100
TIMEOUT = 240


def device_of(case: dict, mesh: Optional[Mesh]) -> torch.device:
    from mgsv_tpu_torch.core import dist
    from mgsv_tpu_torch.core.device import resolve_device

    device = case.get("device", "cpu")
    return resolve_device(dist.rank_device(device) if mesh is not None else device)


def load_model(cfg: Config, weights: str, device) -> MaDe:
    model = MaDe(cfg)
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return model.to(device)


def load_batches(path: str, device) -> list:
    """[global batch] from an npz of key/<i> arrays."""
    z = np.load(path)
    n = 1 + max(int(k.rsplit("/", 1)[1]) for k in z.files)
    return [{k.rsplit("/", 1)[0]: torch.from_numpy(z[k]).to(device) for k in z.files
             if k.endswith(f"/{i}")} for i in range(n)]


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def own(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    return batch if mesh is None else {k: local_rows(v, mesh) for k, v in batch.items()}


def step_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    cfg = Config.from_overrides(case["overrides"])
    device = device_of(case, mesh)
    model = load_model(cfg, case["weights"], device)
    opt = make_optimizer(model, cfg, HORIZON, mesh)
    step = make_train_step(model, cfg, opt, mesh=mesh)
    out: Dict[str, np.ndarray] = {}
    for i, batch in enumerate(load_batches(case["batches"], device)):
        log = step(own(batch, mesh))
        for k, v in log.items():
            if k != "train_iou":
                out[f"log{i}/{k}"] = host(v)
    for name, p in model.named_parameters():
        out[f"param/{name}"] = host(p)
        if p.grad is not None:
            out[f"grad/{name}"] = host(p.grad)
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            out[f"buffer/{name}"] = host(b)
    for name, (mu, nu) in opt.state.items():
        out[f"mu/{name}"], out[f"nu/{name}"] = host(mu), host(nu)
    return out


def dropout_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    """One step at the configured rates: the keep pattern of the first
    plain dropout call (a temporal tower's) and the kernel seeds drawn."""
    masks, seeds = [], []
    plain, draw = L.dropout, L.draw_seed

    def recording_dropout(x, rate, generator):
        if generator is not None and rate > 0.0 and not masks:
            # the keep mask this call draws, from a copy of its generator
            twin = torch.Generator().set_state(generator.get_state())
            masks.append((torch.rand(x.shape, generator=twin) >= rate).numpy())
        return plain(x, rate, generator)

    def recording_seed(generator):
        seeds.append(draw(generator))
        return seeds[-1]

    L.dropout, L.draw_seed = recording_dropout, recording_seed
    try:
        out = step_case(case, mesh)
    finally:
        L.dropout, L.draw_seed = plain, draw
    out["first_mask"] = masks[0]
    out["seeds"] = np.asarray(seeds, np.int64)
    return out


def evaluate_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    from mgsv_tpu_torch.data import synthetic
    from mgsv_tpu_torch.data.device_data import DeviceResidentData
    from mgsv_tpu_torch.eval.evaluator import evaluate
    from mgsv_tpu_torch.eval.similarity import xpool_sim_fused, xpool_sim_fused_sharded

    cfg = Config.from_overrides(case["overrides"])
    model = load_model(cfg, case["weights"], "cpu").eval()
    data = synthetic.open_synthetic(case["data"], cfg.data)
    if case.get("resident"):
        data = DeviceResidentData(data, "cpu", mesh)
    res = evaluate(model, data, cfg, mesh=mesh)
    out = {"ranks": np.asarray(res["ranks"]), "ious": res["ious"],
           "pred_spans": res["pred_spans"], "loss": np.float64(res["loss"]),
           "sim": res["sim"].numpy()}
    out.update({f"metric/{k}": np.float64(v) for part in ("retrieval", "localization",
                                                         "composite")
                for k, v in res[part].items() if np.isscalar(v)})
    z = np.load(case["sim_inputs"])
    video, toks, mask = (torch.from_numpy(z[k]) for k in ("video", "tokens", "mask"))
    xpool = model.xpool
    with torch.no_grad():
        out["corpus_sim"] = (xpool_sim_fused(video, toks, mask, xpool) if mesh is None else
                             xpool_sim_fused_sharded(video, toks, mask, xpool, mesh)).numpy()
    return out


def resident_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    from mgsv_tpu_torch.data import synthetic
    from mgsv_tpu_torch.data.device_data import DeviceResidentData
    from mgsv_tpu_torch.data.pipeline import prefetch_epoch

    cfg = Config.from_overrides(case["overrides"])
    data = synthetic.open_synthetic(case["data"], cfg.data)
    b = cfg.train.batch_size_train
    out = {}
    streams = {"resident": DeviceResidentData(data, "cpu", mesh).epoch_batches(
                   b, shuffle=True, seed=cfg.train.seed, epoch=1),
               "host": prefetch_epoch(data, b, shuffle=True, device="cpu",
                                      seed=cfg.train.seed, epoch=1, mesh=mesh)}
    for kind, stream in streams.items():
        for i, (batch, meta) in enumerate(stream):
            out.update({f"{kind}{i}/{k}": v.numpy() for k, v in batch.items()})
            out[f"{kind}{i}/meta_ids"] = np.asarray(meta.video_ids)
    return out


def similarity_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    from mgsv_tpu_torch.eval import similarity as S
    from mgsv_tpu_torch.models.xpool import XPoolTransformer

    z = np.load(case["inputs"])
    xpool = XPoolTransformer(int(z["mesh_video"].shape[1]))
    xpool.load_state_dict(torch.load(case["weights"], weights_only=True), strict=True)
    out = {}
    with torch.no_grad():
        for name in ("mesh", "sharded"):
            video, toks, mask = (torch.from_numpy(z[f"{name}_{k}"])
                                 for k in ("video", "tokens", "mask"))
            if mesh is None:
                sim = S.xpool_similarity_blocked(xpool, video, toks, mask, block_size=4)
            elif name == "mesh":
                sim = S.xpool_similarity_mesh(xpool, video, toks, mask, mesh, block_size=4)
            else:
                sim = S.xpool_similarity_sharded(xpool, video, toks, mask, mesh, block_size=4)
            out[name] = sim.numpy()
    return out


def engine_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    """Each query of the case's list ([rows, top_k]) through one engine (the
    DETR encoder on #1 where the case says "fused"): the ids as index rows,
    the scores, the moments, the pair rows this rank localized and #1's
    launches."""
    from mgsv_tpu_torch.ops.cuda import fused_encoder_layer as fel
    from mgsv_tpu_torch.serve.engine import MusicIndex, RetrievalEngine

    cfg = Config.from_overrides(case["overrides"])
    model = load_model(cfg, case["weights"], device_of(case, mesh)).eval()
    index = MusicIndex.load(case["index"])
    engine = RetrievalEngine(model, cfg, index, sim_block_size=4,
                             use_fused_kernels=case.get("fused", False),
                             mesh=mesh, mesh_axis=case.get("axis", "dp"))
    rows = []
    core = engine._localize_core
    engine._localize_core = lambda *a: (rows.append(a[0].shape[0]), core(*a))[1]
    z = np.load(case["queries"])
    row_of = {m: i for i, m in enumerate(index.music_ids)}
    out = {}
    for i, (take, top_k) in enumerate(case["queries_list"]):
        rows.clear()
        fel.fused_encoder_layer.launches = 0
        res = engine.query(z["frames"][take], z["fmask"][take], top_k=top_k)
        out[f"q{i}/launches"] = np.int64(fel.fused_encoder_layer.launches)
        out[f"q{i}/ids"] = np.asarray([[row_of[m] for m in r["music_ids"]] for r in res])
        for key in ("retrieval_scores", "moments", "moment_scores"):
            out[f"q{i}/{key}"] = np.asarray([r[key] for r in res], np.float64)
        out[f"q{i}/localized_rows"] = np.int64(sum(rows))
    return out


CASES = {"step": step_case, "dropout": dropout_case, "evaluate": evaluate_case,
         "resident": resident_case, "similarity": similarity_case, "engine": engine_case}


def run_case(case: dict, mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    return CASES[case["kind"]](case, mesh)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_all(procs, what: str) -> list:
    """(stdout, stderr) of each process; a process that does not finish in
    TIMEOUT is killed with the others, and any that fails fails the
    caller."""
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{what}: exited {p.returncode}\n{out[-3000:]}{err[-3000:]}"
    return outs


def launch(cases: Dict[str, dict], tmp: str, world: int, device: str = "cpu",
           mesh_shape=(-1, 1)) -> dict:
    """Run `cases` on `world` ranks of this file, one process each, on
    `device`, over a mesh of `mesh_shape`: {case: [each rank's results]}."""
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"coordinator": f"localhost:{free_port()}", "world": world, "out": out,
                   "device": device, "cases": cases, "mesh_shape": list(mesh_shape)}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r)],
                              cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(world)]
    wait_all(procs, "rank")
    return {name: [dict(np.load(os.path.join(out, f"{name}.rank{r}.npz")))
                   for r in range(world)] for name in cases}


def first_update(run: dict, name: str, cfg: Config) -> np.ndarray:
    """The first Adam update of parameter `name` from the run's moments,
    in float64: lr * (mu / (1 - b1)) / (sqrt(nu / (1 - b2)) + eps).  Two
    runs whose moments agree within their tolerance may still move a
    weight whose clipped gradient is near Adam's eps by different
    fractions of lr; their weights may differ by this much."""
    t = cfg.train
    mu, nu = (run[f"{k}/{name}"].astype(np.float64) for k in ("mu", "nu"))
    return t.matching_lr * (mu / (1 - t.adam_b1)) / (np.sqrt(nu / (1 - t.adam_b2)) + t.adam_eps)


def assert_close_to_one_process(got: dict, want: dict, cfg: Config) -> None:
    """A rank's step results against one process's, after one update (the
    tolerances of tests/test_torch_port_dist.py's docstring)."""
    assert cfg.train.detection_lr == cfg.train.matching_lr
    logs = [k for k in want if k.startswith("log")]
    assert {k for k in got if k.startswith("log")} == set(logs) - {
        k for k in logs if k.endswith("grad_norm") and cfg.train.gradient_accumulation_steps > 1}
    for k in logs:
        if k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert {k for k in got if k.startswith("grad/")} == {k for k in want if k.startswith("grad/")}
    scale = [np.abs(v).max() for k, v in want.items() if k.startswith(("grad/", "mu/"))]
    floor = 1e-7 * max(scale)
    for key in want:
        if key.startswith(("grad/", "mu/", "nu/", "buffer/")):
            tol = 1e-5 * np.abs(want[key]).max() + floor
            assert np.abs(got[key] - want[key]).max() <= tol, key
    for key in want:
        if key.startswith("param/"):
            name = key[len("param/"):]
            slack = 0.0
            if f"mu/{name}" in want:
                slack = np.abs(first_update(got, name, cfg) - first_update(want, name, cfg))
            assert (np.abs(got[key] - want[key]) <= slack + 1e-6).all(), key


def main() -> None:
    from mgsv_tpu_torch.core import dist
    from mgsv_tpu_torch.core.mesh import make_mesh

    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    dist.initialize(spec["coordinator"], spec["world"], rank, spec["device"])
    mesh = make_mesh(spec.get("mesh_shape", (-1, 1)))
    for name, case in spec["cases"].items():
        np.savez(os.path.join(spec["out"], f"{name}.rank{rank}.npz"), **run_case(case, mesh))
    dist.shutdown()


if __name__ == "__main__":
    main()
