"""CUDA graphs captured during the window (align.programs.GraphCache's
n_graph_capture): a shape set the warm-up did not meet, captured while
batches wait."""


def read(ctx):
    return int(ctx["prof"].get("n_graph_capture", 0))
