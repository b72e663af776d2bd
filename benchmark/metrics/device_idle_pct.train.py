"""The card's idle share of the traced window: 100 x (1 - the seconds
in which a device operation ran / the window's seconds on the host
clock)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.window_s or not tr.busy_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
