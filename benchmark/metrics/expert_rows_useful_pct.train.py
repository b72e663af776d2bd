"""The share of the rows that the held routed experts' products ran
that carry an assignment of a real token to that expert, over the
traced window: 100 x the program's counter ``moe.held`` over its counter
``moe.expert_rows`` (``vivqa_tpu_torch.utils.profiling.counters``, which
count only while a profiler records). A dropless layer that runs each
expert on its own tokens reads 100; one that ran every held expert on
every token would read about k / E. Nothing where the program has no
such counters or ran no row."""


def read(ctx):
    try:
        from vivqa_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("moe.expert_rows") or "moe.held" not in c:
        return None
    return 100.0 * c["moe.held"] / c["moe.expert_rows"]
