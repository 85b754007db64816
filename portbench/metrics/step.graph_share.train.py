"""Share of the window's training steps that replayed the port's CUDA
graphs (train/graphs.py), in percent: of the last `units` records of the
span "step" taken with no profiler running, those whose step id also has
a record of the span "step.replay" (the host's preparation of a replayed
step), read from the program's rings.  None where the program records no
"step.replay", as a program without the graphs."""

from mgsv_tpu_torch.core import profiling


def read(ctx):
    n = ctx.host.get("units")
    records = getattr(profiling, "span_records", None)
    if not n or records is None:
        return None
    replayed = {r.step for r in records("step.replay")}
    if not replayed:
        return None
    steps = [r.step for r in records("step") if not r.profiled][-n:]
    return 100.0 * sum(s in replayed for s in steps) / len(steps) if steps else None
