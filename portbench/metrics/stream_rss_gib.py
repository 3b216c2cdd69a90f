"""Growth of the process's peak RSS (ru_maxrss) from the end of the
engine's construction to its last finished batch, in GiB (align.engine's
rss_peak_gib, refreshed each batch, less rss_built_gib). Nothing from a
program without the counters."""


def read(ctx):
    p = ctx["prof_total"]
    if "rss_peak_gib" not in p or "rss_built_gib" not in p:
        return None
    return float(p["rss_peak_gib"] - p["rss_built_gib"])
