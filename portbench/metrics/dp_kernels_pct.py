"""Device time of the DP kernels K1 and K2 (csrc/extd2_fwd.cu,
csrc/extd2_tb.cu; inside the DP graphs' replays) in the traced window,
by kernel name from the profiler's trace, as a share of the window.
Nothing when the trace holds no such kernel."""


def read(ctx):
    by_name = ctx.get("kernel_s") or {}
    s = sum(v for k, v in by_name.items()
            if any(n in k for n in ctx["dp_kernels"]))
    return 100.0 * s / ctx["window_s"] if s > 0 else None
