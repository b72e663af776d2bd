"""The serving attention kernel's share of its roofline: the least time
of the traced batches' attention calls (bytes at the card's bandwidth
or operations at the bf16 peak, the larger) over the device time of the
kernels named for it; nothing where no such kernel ran."""

from benchmark.counts import bound_seconds

KERNELS = ("flash_attn_fwd_serve", "flash_attn_fwd_merge")


def read(ctx):
    spent = ctx["trace"].device_seconds(KERNELS)
    work = ctx["attention"].get("forward_serve", [])
    bound = bound_seconds(work, ctx["card"])
    if not spent or not work or bound is None:
        return None
    return 100.0 * bound * ctx["traced_calls"] / spent
