"""Seconds the engine took to build the index's device tables and upload
them (index.device.to_device; the engine's index_upload), part of
set-up."""


def read(ctx):
    v = ctx["prof_total"].get("index_upload")
    return float(v) if v else None
