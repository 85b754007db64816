"""The whole evaluation's share of the card's dense peak for the
configuration's compute dtype: the frozen FLOP count of one pass
(flops.eval_pass_flops: every batch's forward and the corpus similarity)
times the window's passes, over the window's seconds, in %."""


def read(ctx):
    h = ctx.host
    if not h.get("window_s") or not h.get("flops") or not ctx.peak_flops:
        return None
    return h["flops"] / h["window_s"] / ctx.peak_flops * 100.0
