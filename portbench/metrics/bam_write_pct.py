"""The BAM write on the main thread (cli.main._run_aln_stream's bam_write
span around write_blob and the writer's close: the BGZF compression
every 8 MB) over the window, as a share of the window. Nothing from a
program without the span."""


def read(ctx):
    v = ctx["prof"].get("bam_write_s")
    return None if v is None else 100.0 * v / ctx["window_s"]
