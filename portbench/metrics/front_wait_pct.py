"""Host wait for the device front, chain and collect (ops.seeding,
ops.chain, ops.collect in align.programs.front_program: the engine's
sync_chain) over the window, as a share of the window."""


def read(ctx):
    return 100.0 * ctx["prof"].get("sync_chain", 0.0) / ctx["window_s"]
