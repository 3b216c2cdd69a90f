"""Share of the window in which the main thread was under no program span
(one less align.engine's main_traced_s over the window): Python glue
and whatever no span names yet. Nothing from a program without the
counter."""


def read(ctx):
    v = ctx["prof"].get("main_traced_s")
    return None if v is None else 100.0 * (1.0 - v / ctx["window_s"])
