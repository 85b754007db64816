"""The host's seconds an evaluation: the untraced window's host seconds
over the whole evaluations it ran, each ending on the host (what the
Trainer waits for after an epoch)."""


def read(ctx):
    h = ctx.host
    if not h.get("window_s") or not h.get("units"):
        return None
    return h["window_s"] / h["units"]
