"""The training step replayed as CUDA graphs (train/step.py::make_train_step).

The step's body hands each of its four phases to a `phase(name, fn)`
callback: "step.forward", "step.loss", "step.backward" and
"step.optimizer".  Run eagerly, the callback opens the phase's span and
calls fn.  `StepGraphs` captures each phase once as a CUDA graph of its
own, all four in one memory pool, and from then on replays them in capture
order, each inside its span, so the host issues four graph launches where
it issued some 3,500 kernel launches.

A replay runs what the capture recorded, host values included, so no
launch of the step takes a host value that changes from step to step:

  - the kernels' Philox seeds sit in the slots of a `StepSeeds` buffer
    (models/layers.py), written before each replay from the offsets the
    shapes' first, eager call drew them at (`seed_at`: the same seeds);
  - Adam's count, bias corrections and learning rates sit in
    `GroupedAdam.scalars`, staged before each replay;
  - the plain dropout draws from one CUDA generator, re-seeded in place
    each step and registered with every graph, which reads its seed and
    offset when it is replayed;
  - the batch is copied into the graphs' own input tensors.

Per set of batch shapes (at most MAX_SHAPES; further shapes run eagerly):
the first call runs eagerly, on the capture stream, so that every kernel
is built and every lazy initialization happens outside a capture, and
records the seed offsets; the second captures the four phases, then
replays them; later calls replay.  A replay puts the graphs' gradients back
into each parameter's .grad, advances each kernel wrapper's `launches`
counter by the calls the capture recorded (the launches the replay makes)
and the optimizer's update count by what the captured step advanced it,
and returns clones of the graphs' log tensors, which the next replay
overwrites.

The graphs hold the addresses of the parameters, the optimizer's state,
the seed buffer and the generator: none may be reallocated after the
first call.  The pool keeps about one step's activations per set of
shapes, beside the eager allocator's cache.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mgsv_tpu_torch.core.profiling import span
from mgsv_tpu_torch.models.layers import StepSeeds
from mgsv_tpu_torch.train.optimizer import GroupedAdam

MAX_SHAPES = 2

Body = Callable[[Dict[str, torch.Tensor], Callable], Dict[str, torch.Tensor]]


def engages(device: torch.device, mesh, accumulation_steps: int) -> bool:
    """Whether a training step replays as graphs: on a CUDA device, without
    a mesh (a data-parallel step's gradient sync would need NCCL inside the
    graph) and at one micro-batch an update (accumulation changes the body
    every k-th call)."""
    return device.type == "cuda" and mesh is None and accumulation_steps == 1


def eager_phase(name: str, fn: Callable):
    """Run one phase of the step's body now, inside its span."""
    with span(name):
        return fn()


def kernel_counters() -> List[Callable]:
    """The kernel wrappers that count their launches (`fn.launches`)."""
    from mgsv_tpu_torch.ops.cuda import (flash_attention, fused_decoder_layer,
                                         fused_encoder_layer, fused_temporal_layer, xpool_sim)
    return [fn for mod in (fused_encoder_layer, fused_temporal_layer, fused_decoder_layer,
                           flash_attention, xpool_sim)
            for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")]


def _shapes(batch: Dict[str, torch.Tensor]) -> Tuple:
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in batch.items()))


@dataclasses.dataclass
class _Captured:
    offsets: List[int]                       # the seed offsets of the shapes' eager call
    inputs: Dict[str, torch.Tensor]          # the graphs' copy of the batch
    graphs: List[Tuple[str, torch.cuda.CUDAGraph]]
    log: Dict[str, torch.Tensor]
    grads: List[Optional[torch.Tensor]]
    launches: List[Tuple[Callable, int]]     # (kernel wrapper, launches a replay makes)
    count_advance: int                       # the optimizer's update count, per replay


class StepGraphs:
    """step(batch, key) -> log: `body` eager, captured or replayed, as the
    module docstring says.  key: the seed the caller re-seeded `generator`
    with for this step (the kernel seeds derive from it)."""

    def __init__(self, body: Body, params: List[torch.nn.Parameter],
                 optimizer: GroupedAdam, generator: torch.Generator):
        self.body, self.params, self.optimizer = body, params, optimizer
        self.generator = generator
        self.seeds = StepSeeds(generator.device)
        self.stream = torch.cuda.Stream(generator.device)
        self.recorded: Dict[Tuple, List[int]] = {}
        self.captured: Dict[Tuple, _Captured] = {}
        self._grads_of: Optional[_Captured] = None   # whose gradients .grad holds

    def __call__(self, batch: Dict[str, torch.Tensor], key: int) -> Dict[str, torch.Tensor]:
        shapes = _shapes(batch)
        entry = self.captured.get(shapes)
        if entry is None and shapes in self.recorded:
            entry = self.captured[shapes] = self._capture(batch, key, self.recorded[shapes])
        elif entry is None:
            return self._eager(batch, record=shapes if len(self.recorded) < MAX_SHAPES else None)
        else:
            with span("step.replay"):
                self._prepare(entry, key)
                for name, t in entry.inputs.items():
                    t.copy_(batch[name])
        if self._grads_of is not entry:
            for p, g in zip(self.params, entry.grads):
                p.grad = g
            self._grads_of = entry
        for name, graph in entry.graphs:
            with span(name):
                graph.replay()
        self.optimizer.count += entry.count_advance
        for fn, n in entry.launches:
            fn.launches += n
        return {k: v.clone() for k, v in entry.log.items()}

    def _eager(self, batch, record: Optional[Tuple]) -> Dict[str, torch.Tensor]:
        """The body eagerly; with `record`, on the capture stream, keeping
        the seed offsets for the shapes' capture."""
        self._grads_of = None
        if record is None:
            with self.seeds.drawing():
                return self.body(batch, eager_phase)
        current = torch.cuda.current_stream(self.generator.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), self.seeds.drawing():
            log = self.body(batch, eager_phase)
        current.wait_stream(self.stream)
        self.recorded[record] = list(self.seeds.offsets)
        return log

    def _prepare(self, entry: _Captured, key: int) -> None:
        """Write this step's kernel seeds and Adam's scalars where the graphs
        read them, without a wait for the device."""
        self.seeds.write(key, entry.offsets)
        self.optimizer.stage()

    def _capture(self, batch, key: int, offsets: List[int]) -> _Captured:
        """Capture the four phases of one step on `batch`; nothing runs
        until the caller replays them."""
        entry = _Captured(offsets, {k: v.clone() for k, v in batch.items()}, [], {}, [], [], 0)
        self._prepare(entry, key)
        pool = torch.cuda.graph_pool_handle()
        counters = {fn: fn.launches for fn in kernel_counters()}
        count = self.optimizer.count

        def capture(name: str, fn: Callable):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = fn()
            entry.graphs.append((name, graph))
            return out

        # the draw that steps the generator on inside the capture
        # (StepSeeds.draw), built and loaded outside it
        torch.empty(1, device=self.generator.device).uniform_(
            generator=torch.Generator(self.generator.device))
        with self.seeds.drawing(capturing=True):
            entry.log = self.body(entry.inputs, capture)
        if len(self.seeds.offsets) != len(offsets):
            raise RuntimeError(f"the captured step drew {len(self.seeds.offsets)} kernel "
                               f"seeds, its eager call {len(offsets)}")
        entry.grads = [p.grad for p in self.params]
        entry.launches = [(fn, fn.launches - n) for fn, n in counters.items()
                          if fn.launches != n]
        for fn, n in counters.items():      # a capture launches nothing: the replays count
            fn.launches = n
        entry.count_advance = self.optimizer.count - count
        self.optimizer.count = count
        return entry
