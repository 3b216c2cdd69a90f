"""Share of the traced window in which no operation ran on the card: one
less the union of the device intervals of its kernels, copies and sets
(harness.device_breakdown, from the profiler's trace) over the window.
Nothing without a device trace."""


def read(ctx):
    busy = ctx.get("busy_s")
    if not busy:
        return None
    return 100.0 * (1.0 - busy / ctx["window_s"])
