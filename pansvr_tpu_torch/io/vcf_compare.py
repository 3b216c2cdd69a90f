"""Tolerance-aware SV call-set comparison (truvari-style matching).

The reference pipeline's evaluation matches called SVs against a truth
set with positional and size tolerances rather than byte equality,
because several of its behaviors are rand()-seeded (alignment tie-breaks
read_realignment.cpp:246, occurrence sampling deBGA_index.cpp:225-237)
and breakpoints jitter a few bases between otherwise-identical runs.
This module is the comparator those evaluations need: greedy best-match
per truth call within ``pos_tol`` / size ratio ``size_sim`` of the same
SV type, with each divergence classified so parity hunts can bucket
residuals (EXACT / POS_SHIFT / LEN_DIFF / BOTH / MISSED / EXTRA).

Defaults follow the common SV benchmarking convention (truvari:
refdist 500, pctsize 0.7); the golden parity tests use much tighter
tolerances (pos_tol 20, size_sim 0.9).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .vcf import VCFReader, VCFRecord


@dataclass
class SVCall:
    chrom: str
    pos1: int
    sv_type: str
    svlen: int
    end: int
    filter: str = "."
    rec: VCFRecord | None = None

    def key(self) -> str:
        return f"{self.chrom}:{self.pos1}:{self.sv_type}:{self.svlen}"


def call_from_record(rec: VCFRecord) -> SVCall | None:
    """Derive (type, len, end) from INFO or REF/ALT allele lengths, the
    same derivation fc_anchor_ref applies to its input VCF."""
    info = rec.info if isinstance(rec.info, dict) else {}
    svt = info.get("SVTYPE")
    svlen = info.get("SVLEN")
    end = info.get("END")
    if svt is None:
        if not rec.alts or rec.alts[0].startswith("<"):
            return None
        # symbolic-free records: classify by allele length difference
        diff = len(rec.alts[0]) - len(rec.ref)
        svt = "INS" if diff > 0 else ("DEL" if diff < 0 else "SNP")
        svlen = diff
    if isinstance(svlen, str):
        try:
            svlen = int(svlen.split(",")[0])
        except ValueError:
            svlen = None
    if svlen is None:
        if rec.alts and not rec.alts[0].startswith("<"):
            svlen = len(rec.alts[0]) - len(rec.ref)
        elif end is not None:
            svlen = -(int(end) - rec.pos1) if svt == "DEL" else int(end) - rec.pos1
        else:
            svlen = 0
    if end is not None:
        end_i = int(end)
    else:
        end_i = rec.pos1 + (abs(int(svlen)) if svt != "INS" else 0)
    return SVCall(chrom=rec.chrom, pos1=rec.pos1, sv_type=str(svt),
                  svlen=int(svlen), end=end_i, filter=rec.filter, rec=rec)


def load_calls(path: str, pass_only: bool = False,
               types: tuple | None = None) -> list[SVCall]:
    calls = []
    with VCFReader(path) as rd:
        for rec in rd:
            c = call_from_record(rec)
            if c is None:
                continue
            if pass_only and c.filter not in (".", "PASS", ""):
                continue
            if types and c.sv_type not in types:
                continue
            calls.append(c)
    return calls


@dataclass
class Match:
    truth: SVCall
    query: SVCall
    pos_dist: int
    size_sim: float

    @property
    def cls(self) -> str:
        pos_exact = self.pos_dist == 0
        len_exact = self.truth.svlen == self.query.svlen
        if pos_exact and len_exact:
            return "EXACT"
        if pos_exact:
            return "LEN_DIFF"
        if len_exact:
            return "POS_SHIFT"
        return "BOTH"


@dataclass
class CompareResult:
    matches: list[Match] = field(default_factory=list)
    missed: list[SVCall] = field(default_factory=list)   # truth, unmatched
    extra: list[SVCall] = field(default_factory=list)    # query, unmatched

    @property
    def n_truth(self) -> int:
        return len(self.matches) + len(self.missed)

    @property
    def n_query(self) -> int:
        return len(self.matches) + len(self.extra)

    @property
    def recall(self) -> float:
        return len(self.matches) / self.n_truth if self.n_truth else 0.0

    @property
    def precision(self) -> float:
        return len(self.matches) / self.n_query if self.n_query else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def class_counts(self) -> dict[str, int]:
        d: dict[str, int] = {}
        for m in self.matches:
            d[m.cls] = d.get(m.cls, 0) + 1
        d["MISSED"] = len(self.missed)
        d["EXTRA"] = len(self.extra)
        return d

    def summary_lines(self) -> list[str]:
        out = [
            f"truth {self.n_truth}  query {self.n_query}  "
            f"matched {len(self.matches)}",
            f"recall {self.recall:.4f}  precision {self.precision:.4f}  "
            f"F1 {self.f1:.4f}",
            "classes: " + " ".join(
                f"{k}={v}" for k, v in sorted(self.class_counts().items())
            ),
        ]
        for c in self.missed:
            out.append(f"MISSED {c.key()}")
        for c in self.extra:
            out.append(f"EXTRA  {c.key()}")
        return out


def _size_sim(a: int, b: int) -> float:
    a, b = abs(a), abs(b)
    if a == 0 and b == 0:
        return 1.0
    if a == 0 or b == 0:
        return 0.0
    return min(a, b) / max(a, b)


def compare_calls(truth: list[SVCall], query: list[SVCall],
                  pos_tol: int = 500, min_size_sim: float = 0.7,
                  type_strict: bool = True) -> CompareResult:
    """Greedy best-match: each truth call takes its best unclaimed query
    candidate (same chrom, |Δpos| ≤ pos_tol, size similarity ≥
    min_size_sim, same type unless type_strict=False), best = smallest
    |Δpos| then highest size similarity. One-to-one matching."""
    res = CompareResult()
    by_chrom: dict[str, list[tuple[int, SVCall]]] = {}
    for j, q in enumerate(query):
        by_chrom.setdefault(q.chrom, []).append((j, q))
    claimed: set[int] = set()
    # process truth in a stable order; ties resolved by pos
    for t in sorted(truth, key=lambda c: (c.chrom, c.pos1)):
        best = None
        for j, q in by_chrom.get(t.chrom, []):
            if j in claimed:
                continue
            if type_strict and q.sv_type != t.sv_type:
                continue
            dist = abs(q.pos1 - t.pos1)
            if dist > pos_tol:
                continue
            ss = _size_sim(t.svlen, q.svlen)
            if ss < min_size_sim:
                continue
            cand = (dist, -ss, j)
            if best is None or cand < best:
                best = cand
        if best is None:
            res.missed.append(t)
        else:
            dist, negss, j = best
            claimed.add(j)
            res.matches.append(Match(t, query[j], dist, -negss))
    for j, q in enumerate(query):
        if j not in claimed:
            res.extra.append(q)
    return res


def compare_vcfs(truth_vcf: str, query_vcf: str, pos_tol: int = 500,
                 min_size_sim: float = 0.7, pass_only: bool = False,
                 types: tuple | None = None) -> CompareResult:
    return compare_calls(
        load_calls(truth_vcf, pass_only=pass_only, types=types),
        load_calls(query_vcf, pass_only=pass_only, types=types),
        pos_tol=pos_tol, min_size_sim=min_size_sim,
    )
