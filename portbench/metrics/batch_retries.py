"""Batches the adaptive layer ran again during the window
(align.engine._finish_front's n_retry: a widened lane pool after an
overflow)."""


def read(ctx):
    return int(ctx["prof"].get("n_retry", 0))
