"""Requests completed over the increase of the micro-batcher's
`MicroBatcher.dispatches` counter (serve/server.py) across the window."""


def read(ctx):
    h = ctx.host
    if not h.get("dispatches"):
        return None
    return h["completed"] / h["dispatches"]
