"""Kernel and graph launches the host issued per answered batch, from the
traced window's CUDA runtime and driver API calls (a graph launch counts
once); nothing where the trace holds no launch call."""


def read(ctx):
    launches = ctx["trace"].launches
    return launches / ctx["traced_calls"] if launches else None
