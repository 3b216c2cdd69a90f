"""Signal FASTQ reading for the port's fc_aln.

The same two functions as pansvr_tpu/pipeline.py (read_signal_fastq,
parse_signal_comment); tests/test_torch_engine.py holds the two copies
equal.
"""

from __future__ import annotations

from .align.host_align import OriResult


def parse_signal_comment(comment: str):
    """Signal-read comment -> (OriResult of the original alignment, the
    STAT block as a dict or None)."""
    fields = comment.split("_")
    ori = OriResult(
        chr_id=int(fields[0]),
        ref_bg=int(fields[1]),
        read_bg=int(fields[2]),
        align_score=int(fields[3]),
        mapq=int(fields[4]),
    )
    flags = fields[9]
    ori.direction = 0 if flags[0] == "F" else 1
    ori.unmapped = flags[1] == "Y"
    stats = None
    if "STAT" in fields:
        k = fields.index("STAT")
        stats = dict(
            read_len=int(fields[k + 1]), min_isize=int(fields[k + 2]),
            mid_isize=int(fields[k + 3]), max_isize=int(fields[k + 4]),
        )
    return ori, stats


def read_signal_fastq(path: str):
    """Yield (name, seq, qual, comment) from a signal FASTQ."""
    with open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            seq = fh.readline().strip()
            fh.readline()
            qual = fh.readline().strip()
            name, _, comment = h[1:].strip().partition(" ")
            yield name, seq, qual, comment
