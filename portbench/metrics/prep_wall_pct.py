"""Wall of the engine's prep worker (align.engine._prep_batch: encode,
STR screen, packing; a thread that shares the GIL) over the window, as a
share of the window."""


def read(ctx):
    return 100.0 * ctx["prof"].get("prep_s", 0.0) / ctx["window_s"]
