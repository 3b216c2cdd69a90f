"""Resident anonymous memory at the end of the window's stream, in GiB
(align.engine's rss_end_anon_gib: the Rss of every mapping with no path
or a [...] pseudo-path, from /proc/self/smaps): the heap, torch's host
tensors and the pinned host blocks. Nothing from a program without the
counter."""


def read(ctx):
    v = ctx["prof_total"].get("rss_end_anon_gib")
    return None if v is None else float(v)
