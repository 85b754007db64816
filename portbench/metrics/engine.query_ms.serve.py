"""Mean host milliseconds of serve/engine.py::RetrievalEngine.query, timed by
a proxy that the benchmark hands the micro-batcher in place of the engine,
over the window."""


def read(ctx):
    return ctx.host.get("engine_query_s", 0.0) * 1e3 or None
