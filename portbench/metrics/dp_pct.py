"""The DP's host dispatch (layout and enqueue or replay) and the wait for
its results (align.engine's dp_dispatch + sync_dp; ops.extd2_cuda) over
the window, as a share of the window."""


def read(ctx):
    p = ctx["prof"]
    return 100.0 * (p.get("dp_dispatch", 0.0) + p.get("sync_dp", 0.0)) \
        / ctx["window_s"]
