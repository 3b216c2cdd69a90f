"""Bytes of the pinned blocks PyTorch's caching host allocator owns at
the end of the window's stream, cached ones included, in GiB
(align.engine's pinned_host_gib, from torch.cuda.host_memory_stats'
allocated_bytes.current): pinned memory the process keeps for its life.
Nothing from a program without the counter (or off a card)."""


def read(ctx):
    v = ctx["prof_total"].get("pinned_host_gib")
    return None if v is None else float(v)
