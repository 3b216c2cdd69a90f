"""Main thread's host submit (align.engine._submit_prepped: the wait for
the prep future plus the front's staging and replay) over the window, as
a share of the window."""


def read(ctx):
    return 100.0 * ctx["prof"].get("host_submit", 0.0) / ctx["window_s"]
