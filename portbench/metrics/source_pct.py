"""The main thread's wait on the batch source (align.engine's source span
around next() on it: the FASTQ reader and the comment parsing) over the
window, as a share of the window. Nothing from a program without the
span."""


def read(ctx):
    v = ctx["prof"].get("source_s")
    return None if v is None else 100.0 * v / ctx["window_s"]
