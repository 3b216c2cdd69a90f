"""Whether the records the window wrote are right: the plain reference
(reference/, a frozen copy of the host aligner's arithmetic and of the
Python emit, on its own index of the same anchors) aligns and pairs a
sample of the window's read pairs, drawn from the seed, and each pair's
BAM records must equal the program's byte for byte (none where the
realignment does not beat the original alignment). Imports nothing of
the program.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .reference.bam_out import BamHeader, emit_pair, encode_record
from .reference.host_align import (AlignParams, HostAligner, OriResult,
                                   PEScorer)

# the configuration's scoring (AlignParams' defaults: fc_aln's flags and
# KSW_ALN_handler's band); the control breaks its two-piece gap cost
CONTROL_PARAMS = dict(gap_open2=16, gap_ex2=1)


def parse_ori(comment: str) -> OriResult:
    """The original alignment a signal comment carries (pipeline.py's
    parse_signal_comment)."""
    f = comment.split("_")
    ori = OriResult(chr_id=int(f[0]), ref_bg=int(f[1]), read_bg=int(f[2]),
                    align_score=int(f[3]), mapq=int(f[4]))
    ori.direction = 0 if f[9][0] == "F" else 1
    ori.unmapped = f[9][1] == "Y"
    return ori


def parse_pair(text: str):
    """The two (name, seq, qual, comment) records of a pair's FASTQ."""
    lines = text.split("\n")
    out = []
    for k in (0, 4):
        name, _, comment = lines[k][1:].partition(" ")
        out.append((name, lines[k + 1], lines[k + 3], comment))
    return out


def expected_records(idx, ref_names: list, status: dict, pairs: list,
                     params: dict | None = None) -> dict:
    """{pair name: sorted record bytes} the reference emits for each pair
    of `pairs` (parse_pair tuples), as fc_aln's stream would: PE-scored,
    and written only where the realignment gains."""
    h = HostAligner(idx, AlignParams(**(params or {})),
                    ori_chrom_names=ref_names)
    pe = PEScorer(h, status["max_isize"] or 600, status["min_isize"] or 200,
                  status["read_len"] or 150)
    header = BamHeader(ref_names)
    out = {}
    for (n1, s1, q1, c1), (_, s2, q2, c2) in pairs:
        st1 = h.align_read(s1, parse_ori(c1))
        st2 = h.align_read(s2, parse_ori(c2))
        pr = pe.pair(st1, st2)
        recs = emit_pair(h, pr, st1, st2, n1, s1, q1, s2, q2, c1, c2,
                         header) if pr.gain_better else []
        out[n1] = sorted(encode_record(r) for r in recs)
    return out


def bam_records(path: str, names: set) -> dict:
    """{name: sorted record bytes} of the records of `names` in a BAM."""
    out = {n: [] for n in names}
    with gzip.open(path, "rb") as fh:
        buf = fh.read(1 << 24)
        if buf[:4] != b"BAM\1":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", buf, 4)[0]
        o = 8 + l_text
        while len(buf) < o + 4:
            buf += fh.read(1 << 24)
        n_ref = struct.unpack_from("<i", buf, o)[0]
        o += 4
        for _ in range(n_ref):
            while len(buf) < o + 4:
                buf += fh.read(1 << 24)
            l_name = struct.unpack_from("<i", buf, o)[0]
            o += 8 + l_name
        eof = False
        while True:
            if len(buf) - o < 4 or len(buf) - o < 4 + struct.unpack_from(
                    "<i", buf, o)[0]:
                if eof:
                    break
                more = fh.read(1 << 24)
                eof = not more
                buf = buf[o:] + more
                o = 0
                continue
            n = struct.unpack_from("<i", buf, o)[0]
            l_name = buf[o + 12]
            name = buf[o + 36 : o + 36 + l_name - 1].decode()
            if name in out:
                out[name].append(bytes(buf[o : o + 4 + n]))
            o += 4 + n
        if len(buf) - o:
            raise ValueError(f"{path}: {len(buf) - o} trailing bytes")
    return {n: sorted(r) for n, r in out.items()}


def sample_pairs(seed: int, lo: int, hi: int, k: int) -> list:
    """k stream pair indices of [lo, hi), drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    k = min(k, hi - lo)
    return sorted(int(i) for i in lo + rng.choice(hi - lo, k, replace=False))


def mismatched(got: dict, want: dict) -> list:
    """Names whose records differ."""
    return sorted(n for n in want if got.get(n, []) != want[n])
