"""Resident memory of the process's shared-library mappings at the end of
the window's stream, in GiB (align.engine's rss_end_lib_gib: the Rss of
every mapping whose path is a .so, from /proc/self/smaps): pages of
libtorch, the CUDA libraries and the extension modules, which no change
to the program's own code sheds. Nothing from a program without the
counter."""


def read(ctx):
    v = ctx["prof_total"].get("rss_end_lib_gib")
    return None if v is None else float(v)
