"""How unevenly the held routed experts are loaded, over the traced
window: 100 x the program's counter ``moe.held_peak`` (each MoE call's
number of held experts times its busiest held expert's assignments)
over its counter ``moe.held`` (the assignments they computed). 100
means every held expert took the same share; the layer's time follows
its busiest expert where experts run side by side. Nothing where the
program has no such counters or computed no assignment."""


def read(ctx):
    try:
        from vivqa_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("moe.held") or "moe.held_peak" not in c:
        return None
    return 100.0 * c["moe.held_peak"] / c["moe.held"]
