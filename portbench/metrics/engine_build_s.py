"""Seconds of the engine's construction (align.engine.AlignEngine's
engine_build span: the host aligner, the KSW tables, the packed
reference, the graph caches) without the index upload in it, part of
set-up. Nothing from a program without the span."""


def read(ctx):
    p = ctx["prof_total"]
    if "engine_build" not in p:
        return None
    return float(p["engine_build"] - p.get("index_upload", 0.0))
