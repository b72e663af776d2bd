"""The share of the rows that the generative decoder projects onto the
vocabulary that carry a label the loss counts, over the traced window:
100 x the program's counter ``decoder.labelled`` over its counter
``decoder.positions`` (``vivqa_tpu_torch.utils.profiling.counters``, which
count only while a profiler records); nothing where the program has no
such counters or counted no position."""


def read(ctx):
    try:
        from vivqa_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("decoder.positions") or "decoder.labelled" not in c:
        return None
    return 100.0 * c["decoder.labelled"] / c["decoder.positions"]
