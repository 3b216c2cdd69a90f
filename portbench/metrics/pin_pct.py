"""Pinned host allocations on the main thread (align.engine's pin span in
_pinned and _to_host) over the window, as a share of the window (0 on
the CPU, which pins nothing). Nothing from a program without the
span."""


def read(ctx):
    v = ctx["prof"].get("pin_s")
    return None if v is None else 100.0 * v / ctx["window_s"]
