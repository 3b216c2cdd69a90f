"""Growth of the process's peak RSS (ru_maxrss) across the engine's
construction, in GiB (align.engine's engine_rss_gib: the index's host
tables, the upload's staging, the host aligner). Nothing from a program
without the counter."""


def read(ctx):
    v = ctx["prof_total"].get("engine_rss_gib")
    return None if v is None else float(v)
