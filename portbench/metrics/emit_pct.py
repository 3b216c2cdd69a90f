"""The native PE pairing and BAM encoding (align.engine's emit span,
_emit_tail inside host_replay) over the window, as a share of the
window. Nothing from a program without the span."""


def read(ctx):
    v = ctx["prof"].get("emit_s")
    return None if v is None else 100.0 * v / ctx["window_s"]
