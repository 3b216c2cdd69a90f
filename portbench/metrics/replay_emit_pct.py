"""Host collect, replay and emit (align.native_glue's glue_collect*,
glue_replay, glue_pe_emit) over the window, as a share of the window."""


def read(ctx):
    p = ctx["prof"]
    return 100.0 * (p.get("host_collect", 0.0) + p.get("host_replay", 0.0)) \
        / ctx["window_s"]
