"""The training attention kernels' share of their roofline: the least
time of the traced steps' attention calls (each call's bytes at the
card's bandwidth or its operations at the bf16 peak, the larger; the
forward with statistics and the one-pass backward) over the device time
of the kernels named for them; nothing where no such kernel ran."""

from benchmark.counts import bound_seconds

KERNELS = ("flash_attn_fwd_train", "flash_attn_fwd_merge", "flash_attn_bwd")


def read(ctx):
    spent = ctx["trace"].device_seconds(KERNELS)
    work = ctx["attention"].get("forward_train", []) \
        + ctx["attention"].get("backward", [])
    bound = bound_seconds(work, ctx["card"])
    if not spent or not work or bound is None:
        return None
    return 100.0 * bound * ctx["traced_calls"] / spent
