"""The process's peak RSS (ru_maxrss) when the engine's construction
starts, in GiB (align.engine's rss_start_gib): the imports, the CUDA
libraries, the index store opened and the harness's own state, before
the program builds anything. Nothing from a program without the
counter."""


def read(ctx):
    v = ctx["prof_total"].get("rss_start_gib")
    return None if v is None else float(v)
