"""The whole train step's share of the card's dense bf16 peak: the
plain reference's products of a step (forward and backward, counted at
the cell's shapes) times the measured window's steps, over its seconds
on the host clock and the peak. It is the training rate rescaled by a
constant, read from no trace: the ceiling under which a kernel's
roofline share can carry a gain."""

from benchmark.counts import peaks


def read(ctx):
    p = peaks(ctx["card"])
    if p is None:
        return None
    rate = ctx["flops_per_call"] * ctx["window_calls"] / ctx["window_s"]
    return 100.0 * rate / p[0]
