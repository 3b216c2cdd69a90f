"""CPU time of the prep (align.engine._prep_batch's thread CPU seconds,
prep_cpu_s; mostly the prep worker) over the window, as a share of the
window. Beside prep_wall_pct: the gap is the prep's GIL wait and its
time off the CPU. Nothing from a program without the counter."""


def read(ctx):
    v = ctx["prof"].get("prep_cpu_s")
    return None if v is None else 100.0 * v / ctx["window_s"]
