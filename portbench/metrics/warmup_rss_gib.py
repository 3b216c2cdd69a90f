"""The process's VmRSS growth across the eager warm-ups before the CUDA
graph captures, summed over the run (set-up and window), in GiB
(align.programs.GraphCache's warmup_rss_gib): mostly the CUDA modules
the programs' ops load on their first use. Nothing from a program
without the counter."""


def read(ctx):
    v = ctx["prof_total"].get("warmup_rss_gib")
    return None if v is None else float(v)
