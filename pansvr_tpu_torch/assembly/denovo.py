"""De novo SV caller (the reference's `sv_calling` / NovaSV subsystem).

Behavioral re-implementation of src/NovaSVgenerateVCF (SveHandler +
NovaSVRst, SURVEY.md §3.6/§8.4), to the reference's shape:

  - typed signal lists sve[SIG][SV] with SIG in {DR, SH} and SV in
    {DEL, DUP, INS, INV_1, INV_2, TRA, TRA_INV} (sve.hpp:18-30), DR
    typing per handleDRSignal (SveHandler.cpp:406-429), SH clip signals
    per storeClipSignals (SveHandler.cpp:47-60);
  - per-type signal combining: overlap clustering, then breakpoint
    election by stacking the empirical breakpoint-probability
    distribution of each signal and accepting clusters whose peak
    reaches 2x the single-signal maximum (single_type_sve_combine +
    getTopPossibilityIdx, SveHandler.cpp:157-299; distributions per
    getBreakPoint_Distribution, SveHandler.hpp:134-165), then
    BEGIN/END pairing into SOLID SVEs (sve_begin_end_combine,
    SveHandler.cpp:434-465);
  - per-SVE assembly and resolution: normal-mode word-ladder assembly
    for DR/DEL, repeat-mode for SH/INS small variants, and the
    4-orientation repeat-mode BND path for INV_1/INV_2/TRA
    (SVE_handle_region, SveHandler.hpp:906-1011; TRA_INV skipped like
    the reference, :939);
  - genotyping by re-aligning breakpoint-region reads against the
    assembled contig vs their original alignment score, with the
    reference's +-4 margin, min-score gate, 1.5x INS/DEL adjustment and
    3x genotype thresholds (NOVA_SV_FINAL_RST_item::genotyping,
    NovaSVRst.hpp:766-905); emitted as GT:SR;
  - inter-chromosomal junctions emitted as BND record PAIRS with
    MATEID-mirrored coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import BamReader, BamRecord
from ..io.vcf import VCFRecord
from ..ops import ksw2_ref
from ..utils import dna
from .assembler import AssemblyManager


def _dp(qseq, tseq, **params):
    """One DP via the native C++ extd2 kernel (bit-identical to ksw2_ref,
    fuzz-tested); a library without it raises (the port's copy of the
    original, which falls back to the Python oracle)."""
    from ..align import native_glue

    ez = native_glue.extd2_native(native_glue.get_lib(), qseq, tseq, **params)
    if ez is None:
        raise RuntimeError("the native engine glue library has no "
                           "glue_extd2 (rebuild it with "
                           "tools/build_native.sh)")
    return ez

# RST states (sve.hpp:27-30)
BEGIN, END, SOLID, UNKNOWN = 0, 1, 2, 3
SV_TYPES = ("DEL", "DUP", "INS", "INV_1", "INV_2", "TRA", "TRA_INV")


@dataclass
class DeNovoOptions:
    block_size: int = 2_000_000       # RefHandler block (RefHandler.hpp:24)
    block_overlap: int = 1_000
    min_clip: int = 10
    min_support: int = 3
    min_sv_len: int = 30
    isize_min: int = 200
    isize_max: int = 600
    read_len: int = 150
    max_del_dup_length: int = 50_000  # handleDRSignal isize cap
    min_mapq: int = 10
    window_pad: int = 400
    sve_min_solid_score: int = 4      # SVE_MIN_SOLID_SCORE analog
    sve_min_read_num: int = 2


@dataclass
class Region:
    chr_id: int
    st: int
    ed: int

    def overlap(self, other: "Region") -> bool:
        return (self.chr_id == other.chr_id
                and self.st <= other.ed and other.st <= self.ed)

    def combine(self, other: "Region"):
        self.st = min(self.st, other.st)
        self.ed = max(self.ed, other.ed)

    @property
    def middle(self):
        return (self.st + self.ed) // 2


@dataclass
class Sve:
    """SVE_core + SAMPLE_INFO (sve.hpp:34-161)."""
    r1: Region
    r2: Region
    solid: int                   # BEGIN/END/SOLID/UNKNOWN
    score_b: int = 0
    score_e: int = 0
    nread_b: int = 0
    nread_e: int = 0

    @property
    def score(self):
        return self.score_b + self.score_e

    @property
    def nread(self):
        return self.nread_b + self.nread_e

    def combine_info(self, other: "Sve"):
        self.score_b += other.score_b
        self.score_e += other.score_e
        self.nread_b += other.nread_b
        self.nread_e += other.nread_e

    @property
    def sv_len(self):
        return ((self.r2.st + self.r2.ed) - (self.r1.st + self.r1.ed)) // 2


def make_sve(is_begin: int, score: int, r1: Region, r2: Region) -> Sve:
    s = Sve(r1=r1, r2=r2, solid=is_begin)
    if is_begin == BEGIN:
        s.score_b, s.nread_b = score, 1
    elif is_begin == END:
        s.score_e, s.nread_e = score, 1
    return s


def breakpoint_distributions(o: DeNovoOptions):
    """getBreakPoint_Distribution (SveHandler.hpp:134-165) with a
    uniform insert-size pmf over [isize_min, isize_max] (callers with a
    measured pmf can substitute it)."""
    rl = o.read_len
    min_p = max(o.isize_min - 2 * rl, 1)
    max_p = max(o.isize_max - 2 * rl, min_p + 1)
    dr = np.zeros(max_p, np.float64)
    n_sizes = max(o.isize_max - o.isize_min, 1)
    for i in range(min_p, max_p):
        pi = (1.0 / n_sizes) / i
        dr[:i] += pi
    s = dr.sum()
    if s > 0:
        dr /= s
    sh = np.array([(10 - i) ** 2 for i in range(10)], np.float64)
    sh /= sh.sum()
    return dr, sh


class SignalCollector:
    """sve[SIG][SV] construction from one block of reads."""

    def __init__(self, opts: DeNovoOptions):
        self.o = opts
        self.insert_region_len = max(opts.isize_max - opts.read_len, 100)
        self.sve: dict[str, dict[str, list[Sve]]] = {
            "DR": {t: [] for t in SV_TYPES},
            "SH": {t: [] for t in SV_TYPES},
        }
        self.evidence_reads: list[BamRecord] = []

    def collect(self, reads: list[BamRecord]):
        o = self.o
        for rec in reads:
            if rec.is_unmapped or rec.mapq < o.min_mapq:
                continue
            got_signal = False
            # SH clip signals (storeClipSignals: r1 == r2 around the clip)
            if rec.soft_right >= o.min_clip:
                p = rec.end_pos
                self.sve["SH"]["INS"].append(make_sve(
                    BEGIN, min(15, rec.mapq),
                    Region(rec.tid, p, p + 10), Region(rec.tid, p, p + 10)))
                got_signal = True
            if rec.soft_left >= o.min_clip:
                p = rec.pos
                self.sve["SH"]["INS"].append(make_sve(
                    END, min(15, rec.mapq),
                    Region(rec.tid, p - 10, p), Region(rec.tid, p - 10, p)))
                got_signal = True
            if self._handle_dr(rec):
                got_signal = True
            if got_signal:
                self.evidence_reads.append(rec)

    def _handle_dr(self, rec: BamRecord) -> bool:
        """handleDRSignal (SveHandler.cpp:406-429)."""
        o = self.o
        if rec.mate_unmapped or rec.mtid < 0:
            return False
        isz = abs(rec.isize)
        proper = (rec.tid == rec.mtid and rec.is_reverse != rec.mate_reverse
                  and o.isize_min <= isz <= o.isize_max)
        if proper:
            return False
        fwd = not rec.is_reverse
        m_fwd = not rec.mate_reverse
        middle = rec.query_len - rec.soft_left - rec.soft_right
        irl = self.insert_region_len
        t = None
        if rec.tid == rec.mtid and fwd != m_fwd and isz < o.max_del_dup_length:
            is_begin = BEGIN if fwd else END
            normal_ori = (fwd and rec.pos <= rec.mpos) or \
                (not fwd and rec.pos >= rec.mpos)
            if normal_ori:
                if isz > o.isize_max:
                    t = "DEL"
                elif isz < o.isize_min:
                    t = "DUP"
            else:
                t = "DUP"
        elif rec.tid == rec.mtid and fwd == m_fwd:
            is_begin = BEGIN if rec.isize > 0 else END
            t = "INV_1" if fwd else "INV_2"
        elif rec.tid != rec.mtid:
            is_begin = BEGIN if rec.tid < rec.mtid else END
            t = "TRA" if fwd != m_fwd else "TRA_INV"
        if t is None:
            return False
        # SVE DR constructor region math (sve.hpp:149-161)
        this_st = rec.pos + (middle if fwd else -irl)
        mate_st = rec.mpos + (rec.query_len if m_fwd else -irl)
        this_r = Region(rec.tid, this_st, this_st + irl)
        mate_r = Region(rec.mtid, mate_st, mate_st + irl)
        if fwd != m_fwd:
            r1, r2 = (this_r, mate_r) if fwd else (mate_r, this_r)
        else:
            this_smaller = (this_r.chr_id, this_r.st) <= \
                (mate_r.chr_id, mate_r.st)
            r1, r2 = (this_r, mate_r) if this_smaller else (mate_r, this_r)
        self.sve["DR"][t].append(
            make_sve(is_begin, min(15, rec.mapq), r1, r2))
        return True


def single_type_sve_combine(lst: list[Sve], min_score_cutoff: int,
                            sig: str, svt: str, dr_dist, sh_dist,
                            min_accept_dr: float, min_accept_sh: float):
    """SveHandler.cpp:201-299: overlap-grow clusters, elect breakpoints
    by probability stacking, accept on the 2x-single-signal threshold."""
    if sig == "DR":
        min_accept = min_accept_dr
        max_accept_region = len(dr_dist)
        bp_region = 200
        dist = dr_dist
    else:
        min_accept = min_accept_sh
        max_accept_region = 8
        bp_region = 200
        dist = sh_dist
    lst.sort(key=lambda s: (s.r1.chr_id, s.r1.st))
    out: list[Sve] = []
    n = len(lst)
    for i in range(n):
        sve = lst[i]
        if sve.solid == UNKNOWN:
            continue
        is_solid = sve.solid
        try_list = []
        r1_min, r1_max = sve.r1.st, sve.r1.st + 1
        r2_min, r2_max = sve.r2.st, sve.r2.st + 1
        max_score = 0
        j = i
        while j < n and lst[j].r1.chr_id == sve.r1.chr_id \
                and lst[j].r1.st <= r1_max:
            t = lst[j]
            if (t.solid == is_solid and t.r2.chr_id == sve.r2.chr_id
                    and t.r2.st <= r2_max and r2_min <= t.r2.ed
                    and t.r1.ed >= r1_min):
                try_list.append(j)
                r1_min = min(r1_min, t.r1.st)
                r1_max = max(r1_max, t.r1.ed)
                r2_min = min(r2_min, t.r2.st)
                r2_max = max(r2_max, t.r2.ed)
                max_score += t.score
                t.solid = UNKNOWN
            j += 1
        if len(try_list) <= 2 or max_score <= 4 \
                or r1_max - r1_min >= 5000 or r2_max - r2_min >= 5000:
            continue

        def top_possibility(r_min, r_max, use_r1, forward):
            size = min(5000, r_max - r_min + 2)
            poss = np.zeros(size, np.float64)
            dlen = len(dist)
            for k in try_list:
                s = lst[k]
                if forward:
                    st = (s.r1.st if use_r1 else s.r2.st) - r_min
                    hi = min(dlen, size - st)
                    if hi > 0 and st >= 0:
                        poss[st : st + hi] += dist[:hi]
                    elif st < 0:
                        lo = -st
                        if lo < dlen:
                            poss[: min(dlen - lo, size)] += \
                                dist[lo : lo + min(dlen - lo, size)]
                else:
                    ed = (s.r1.ed if use_r1 else s.r2.ed) - r_min
                    for q in range(dlen):
                        p = ed - q
                        if 0 <= p < size:
                            poss[p] += dist[q]
            mi = int(np.argmax(poss))
            return r_min + mi, float(poss[mi])

        fwd1 = svt != "INV_2"
        bp1, p1 = top_possibility(r1_min, r1_max, True, fwd1)
        fwd2 = svt == "INV_1"
        bp2, p2 = top_possibility(r2_min, r2_max, False, fwd2)
        if p1 < min_accept and p2 < min_accept:
            continue
        min_a1, max_a1 = bp1 - max_accept_region, bp1
        min_a2, max_a2 = bp2, bp2 + max_accept_region
        sve_n = 0
        for k in try_list:
            s = lst[k]
            if svt != "INS":
                ok = min_a1 <= s.r1.st <= max_a1 and \
                    min_a2 <= s.r2.ed <= max_a2
            else:
                ok = (min_a1 <= s.r1.st <= max_a1) if is_solid == BEGIN \
                    else (min_a2 <= s.r2.ed <= max_a2)
            if ok:
                sve_n += 1
            else:
                s.solid = is_solid
        score = int(max(p1, p2) * 2 / max(min_accept, 1e-12))
        if score < min_score_cutoff:
            continue
        ns = Sve(r1=Region(sve.r1.chr_id, bp1 - bp_region, bp1 + bp_region),
                 r2=Region(sve.r2.chr_id, bp2 - bp_region, bp2 + bp_region),
                 solid=is_solid)
        ns.r1.st, ns.r1.ed = bp1, bp1 + 1
        ns.r2.st, ns.r2.ed = bp2, bp2 + 1
        if is_solid == BEGIN:
            ns.score_b, ns.nread_b = score, sve_n
        else:
            ns.score_e, ns.nread_e = score, sve_n
        out.append(ns)
    lst[:] = out


def sve_begin_end_combine(lst: list[Sve], min_solid_score: float,
                          min_read_num: float, pad: int):
    """SveHandler.cpp:434-465: pair BEGIN+END into SOLID, filter."""
    lst.sort(key=lambda s: (s.r1.chr_id, s.r1.st))
    out = []
    n = len(lst)
    for i in range(n):
        sve = lst[i]
        if sve.solid == UNKNOWN:
            continue
        for j in range(i + 1, n):
            t = lst[j]
            if t.r1.chr_id != sve.r1.chr_id or t.r1.st > sve.r1.ed + pad:
                break
            if t.solid == UNKNOWN or t.solid == sve.solid:
                continue
            if not (t.r2.chr_id == sve.r2.chr_id
                    and t.r2.st <= sve.r2.ed + pad
                    and sve.r2.st <= t.r2.ed + pad):
                continue
            sve.r1.combine(t.r1)
            sve.r2.combine(t.r2)
            sve.solid = SOLID
            sve.combine_info(t)
            t.solid = UNKNOWN
            break
        if sve.solid < SOLID and (sve.score < min_solid_score * 2
                                  or sve.nread < min_read_num * 2):
            continue
        if sve.solid == SOLID and (sve.score < min_solid_score
                                   or sve.nread < min_read_num):
            continue
        out.append(sve)
    lst[:] = out


class DeNovoCaller:
    def __init__(self, genome, opts: DeNovoOptions | None = None):
        self.genome = genome            # Faidx-like
        self.o = opts or DeNovoOptions()
        self.am = AssemblyManager()
        self.dr_dist, self.sh_dist = breakpoint_distributions(self.o)
        # set_min_accpet_possibility (SveHandler.hpp:842-857)
        self.min_accept_dr = 2.0 * float(self.dr_dist.max(initial=0.0))
        self.min_accept_sh = 2.0 * float(self.sh_dist.max(initial=0.0))

    # ------------------------------------------------------------------
    def call_bam(self, bam_path: str) -> list[VCFRecord]:
        out: list[VCFRecord] = []
        with BamReader(bam_path) as rd:
            chroms = rd.header.ref_names
            buf: list[BamRecord] = []
            cur_tid = -1
            for rec in rd:
                if rec.is_secondary or rec.is_supplementary:
                    continue
                if rec.tid != cur_tid and buf:
                    out.extend(self._call_block(buf, chroms[cur_tid], chroms))
                    buf = []
                cur_tid = rec.tid
                if rec.tid < 0:
                    continue
                buf.append(rec)
                if len(buf) > 1 and (
                    buf[-1].pos - buf[0].pos > self.o.block_size
                ):
                    keep_from = buf[-1].pos - self.o.block_overlap
                    out.extend(self._call_block(buf, chroms[cur_tid], chroms))
                    buf = [r for r in buf if r.pos >= keep_from]
            if buf and cur_tid >= 0:
                out.extend(self._call_block(buf, chroms[cur_tid], chroms))
        return _dedupe_by_proximity(out)

    # ------------------------------------------------------------------
    def _call_block(self, reads: list[BamRecord], chrom: str,
                    chroms: list[str]) -> list[VCFRecord]:
        o = self.o
        sc = SignalCollector(o)
        sc.collect(reads)
        # per-type combine (cluster_and_combine_original_signals)
        for svt in SV_TYPES:
            lst = sc.sve["DR"][svt]
            if lst:
                single_type_sve_combine(
                    lst, 2, "DR", svt, self.dr_dist, self.sh_dist,
                    self.min_accept_dr, self.min_accept_sh)
                if svt == "DEL":
                    sve_begin_end_combine(
                        lst, o.sve_min_solid_score, o.sve_min_read_num,
                        pad=o.isize_max)
                else:
                    sve_begin_end_combine(
                        lst, o.sve_min_solid_score * 1.5,
                        o.sve_min_read_num * 1.5, pad=o.isize_max)
            lst = sc.sve["SH"][svt]
            if lst:
                single_type_sve_combine(
                    lst, 2, "SH", svt, self.dr_dist, self.sh_dist,
                    self.min_accept_dr, self.min_accept_sh)
                sve_begin_end_combine(
                    lst, o.sve_min_solid_score, o.sve_min_read_num,
                    pad=o.isize_max)

        records: list[VCFRecord] = []
        # BND/INV part first (repeat mode; SVE_handle_region part 0)
        for svt in ("INV_1", "INV_2"):
            for sve in sc.sve["DR"][svt]:
                rec = self._resolve_inv(sve, reads, chrom, svt)
                if rec is not None:
                    records.append(rec)
        records.extend(self._call_tra(sc.sve["DR"]["TRA"], reads,
                                      chrom, chroms))
        # TRA_INV explicitly skipped (SveHandler.hpp:939)

        # DEL part (normal mode) + DUP
        for svt in ("DEL", "DUP"):
            for sve in sc.sve["DR"][svt]:
                rec = self._resolve_indel(sve, reads, chrom, sig="DR")
                if rec is not None:
                    records.append(rec)
        # SH/INS small variants (repeat mode)
        for sve in sc.sve["SH"]["INS"]:
            rec = self._resolve_indel(sve, reads, chrom, sig="SH")
            if rec is not None:
                records.append(rec)

        # genotyping pass over the region's resolved SVs
        for rec in records:
            if rec.info.get("SVTYPE") in ("DEL", "INS", "DUP"):
                self._genotype(rec, reads, chrom)
        return records

    # ------------------------------------------------------------------
    def _region_reads(self, reads, lo, hi):
        return [r for r in reads
                if not r.is_unmapped and r.pos < hi and r.end_pos > lo]

    def _evidence_reads(self, reads, lo, hi):
        """Clip or discordant reads touching the window."""
        o = self.o
        out = []
        for r in reads:
            if r.is_unmapped or r.mapq < o.min_mapq:
                continue
            if not (r.pos < hi and r.end_pos > lo):
                continue
            clipped = r.soft_left >= o.min_clip or r.soft_right >= o.min_clip
            isz = abs(r.isize)
            discordant = (r.mtid != r.tid or r.is_reverse == r.mate_reverse
                          or isz > o.isize_max or
                          (0 < isz < o.isize_min))
            if clipped or discordant:
                out.append(r)
        return out

    # ------------------------------------------------------------------
    def _resolve_indel(self, sve: Sve, reads, chrom, sig: str):
        o = self.o
        bp1 = sve.r1.middle
        bp2 = sve.r2.middle
        lo = max(0, min(bp1, bp2) - o.window_pad)
        hi = max(bp1, bp2) + o.window_pad
        support = self._evidence_reads(reads, lo, hi)
        if len(support) < o.min_support:
            return None
        self.am.clear()
        if sig == "DR":
            self.am.set_normal_mode()
        else:
            self.am.set_repeat_mode()
        for r in support[:300]:
            self.am.add_read(r.seq)
        # UM leg: unmapped mates are placed at their anchor's coordinate
        # and carry the only coverage of a long insertion's interior —
        # without them the contig stops at clip-tail depth and the
        # insertion length truncates (the reference feeds them to
        # assembly the same way, SveHandler.hpp:906-1011). Orientation
        # is unknowable without alignment, so both are offered; the
        # word ladder only joins the one that shares words.
        for r in reads:
            if r.is_unmapped and lo <= r.pos <= hi:
                self.am.add_read(r.seq)
                self.am.add_read(_revcomp(r.seq))
        contigs = self.am.assemble()
        if not contigs:
            return None
        contig = max(contigs, key=lambda c: len(c.seq))
        if len(contig.seq) < 60:
            return None

        ref_seq = self.genome.fetch(chrom, lo, hi)
        if len(ref_seq) < 60:
            return None
        q = dna.fill_n(dna.encode(contig.seq))
        t = dna.fill_n(dna.encode(ref_seq))
        ez = _dp(q, t, match=2, mismatch=-12, q=16, e=1,
                            q2=32, e2=0, w=500, zdrop=-1)
        span_lo = min(bp1, bp2) - 50 - lo
        span_hi = max(bp1, bp2) + 50 - lo
        r_clips = [r.end_pos for r in support if r.soft_right >= o.min_clip]
        l_clips = [r.pos for r in support if r.soft_left >= o.min_clip]
        dr_del_votes = sum(
            1 for r in support
            if r.tid == r.mtid and r.is_reverse != r.mate_reverse
            and abs(r.isize) > o.isize_max)
        ins_site = (
            len(r_clips) >= 2 and len(l_clips) >= 2
            and abs(int(np.median(r_clips)) - int(np.median(l_clips))) <= 20
            and dr_del_votes < o.min_support
        )

        def pick_sv(cigar):
            best = None
            ref_pos = 0
            n = len(cigar)
            for ci, (op, ln) in enumerate(cigar):
                interior = 0 < ci < n - 1
                if interior and op == "I" and ln >= o.min_sv_len:
                    if (span_lo <= ref_pos <= span_hi
                            and (best is None or ln > best[2])):
                        best = ("INS", ref_pos, ln)
                elif interior and op == "D" and ln >= o.min_sv_len:
                    if (not ins_site
                            and ref_pos <= span_hi and ref_pos + ln >= span_lo
                            and (best is None or ln > best[2])):
                        best = ("DEL", ref_pos, ln)
                if op in ("M", "D"):
                    ref_pos += ln
            return best

        best = pick_sv(ez.cigar)
        if best is None:
            ez2 = _dp((q[::-1] ^ 3), t, match=2, mismatch=-12,
                                 q=16, e=1, q2=32, e2=0, w=500, zdrop=-1)
            best = pick_sv(ez2.cigar)
            if best is not None:
                ez = ez2
                q = q[::-1] ^ 3
        if best is None:
            return self._resolve_ins_two_sided(support, chrom, dr_del_votes)
        svt, off, ln = best
        bp0 = lo + off
        anchor0 = max(bp0 - 1, 0)
        anchor = self.genome.fetch(chrom, anchor0, anchor0 + 1) or "N"
        n_alt = len(support)
        if n_alt < o.min_support:
            return None

        if svt == "DEL":
            ref_allele = anchor + self.genome.fetch(chrom, bp0, bp0 + ln)
            alt_allele = anchor
            svlen = -ln
            end = bp0 + ln
        else:
            q_pos = 0
            r_pos = 0
            ins_seq = ""
            for op, l2 in ez.cigar:
                if op == "M":
                    q_pos += l2
                    r_pos += l2
                elif op == "I":
                    if r_pos == off and l2 == ln:
                        ins_seq = dna.decode(q[q_pos : q_pos + l2])
                    q_pos += l2
                elif op == "D":
                    r_pos += l2
            if not ins_seq:
                return None
            ref_allele = anchor
            alt_allele = anchor + ins_seq
            svlen = ln
            end = bp0
            # tandem-duplication classification (the reference's DR DUP
            # sve type, sve.hpp:18-24): an insertion whose sequence
            # matches the adjacent reference on either side is a DUP of
            # that segment — emitted as <DUP> spanning it
            for seg_lo, seg_hi in ((bp0 - ln, bp0), (bp0, bp0 + ln)):
                if seg_lo < 0:
                    continue
                seg = self.genome.fetch(chrom, seg_lo, seg_hi)
                if len(seg) != ln:
                    continue
                mism = sum(1 for a, b in zip(seg, ins_seq) if a != b)
                if mism <= max(2, ln // 50):
                    svt = "DUP"
                    bp0 = seg_lo
                    anchor0 = max(bp0 - 1, 0)
                    anchor = self.genome.fetch(
                        chrom, anchor0, anchor0 + 1) or "N"
                    ref_allele = anchor
                    alt_allele = "<DUP>"
                    end = seg_hi
                    break
        rec = VCFRecord(
            chrom=chrom, pos1=anchor0 + 1, id=f"nova.{svt}.{anchor0}",
            ref=ref_allele, alts=[alt_allele], qual=".", filter="PASS",
            info={"SVTYPE": svt, "END": str(end), "SVLEN": str(svlen)},
            format="GT:SR",
            samples=[f"./.:{n_alt},0,0"],
        )
        # contig anchoring for the genotyper: the contig's global start
        # is the window start plus any leading deletion of its alignment
        # (a leading insertion means unaligned contig head — the read-in-
        # contig origin shifts the other way)
        contig_start = lo
        if ez.cigar:
            op0, ln0 = ez.cigar[0]
            if op0 == "D":
                contig_start = lo + ln0
            elif op0 == "I":
                contig_start = lo - ln0
        rec._contig = dna.decode(q)       # the aligned orientation
        rec._contig_ref_pos = contig_start
        return rec

    # ------------------------------------------------------------------
    def _resolve_inv(self, sve: Sve, reads, chrom, svt: str):
        """INV resolution via orientation-aware repeat-mode assembly
        (assembly_variations_BND analog, SveHandler.hpp:929-946): the
        breakpoint-2 side reads are reverse-complemented before
        assembly, so an inversion's contig aligns contiguously against
        the strand-flipped reference window; breakpoints then refine
        from the contig alignment edges."""
        o = self.o
        bp1 = sve.r1.middle
        bp2 = sve.r2.middle
        if abs(bp2 - bp1) < o.min_sv_len:
            return None
        lo1, hi1 = max(0, bp1 - o.window_pad), bp1 + o.window_pad
        lo2, hi2 = max(0, bp2 - o.window_pad), bp2 + o.window_pad
        # same-strand pairs spanning the two windows
        ev = []
        for r in reads:
            if r.is_unmapped or r.mapq < o.min_mapq:
                continue
            if r.tid != r.mtid or r.is_reverse != r.mate_reverse:
                continue
            if (lo1 < r.pos < hi1 and lo2 < r.mpos < hi2) or \
                    (lo2 < r.pos < hi2 and lo1 < r.mpos < hi1):
                ev.append(r)
        n_support = len(ev) + sve.nread
        if len(ev) < 1 or n_support < o.min_support:
            return None
        # split-read refinement: clips vote a precise breakpoint per
        # side; the vote windows are clamped at the midpoint so the two
        # breakpoints' clip piles never mix (the SVE windows overlap
        # when the inversion is shorter than the window pad)
        mid = (bp1 + bp2) // 2
        w1_lo, w1_hi = lo1, min(hi1, mid)
        w2_lo, w2_hi = max(lo2, mid), hi2
        c1 = [r.end_pos for r in reads
              if r.soft_right >= o.min_clip and w1_lo < r.end_pos < w1_hi]
        c1 += [r.pos for r in reads
               if r.soft_left >= o.min_clip and w1_lo < r.pos < w1_hi]
        c2 = [r.end_pos for r in reads
              if r.soft_right >= o.min_clip and w2_lo < r.end_pos < w2_hi]
        c2 += [r.pos for r in reads
               if r.soft_left >= o.min_clip and w2_lo < r.pos < w2_hi]
        rb1 = int(np.median(c1)) if len(c1) >= 2 else bp1
        rb2 = int(np.median(c2)) if len(c2) >= 2 else bp2
        lo_p, hi_p = sorted((rb1, rb2))
        if hi_p - lo_p < o.min_sv_len:
            return None

        # orientation-aware contig check: assemble clip+spanning reads of
        # window 1 in repeat mode; align the contig against the window-1
        # reference with the inverted segment substituted — a true
        # inversion scores an exact/near-exact match
        self.am.clear()
        self.am.set_repeat_mode()
        w_reads = [r for r in self._evidence_reads(reads, lo1, hi1)][:200]
        for r in w_reads:
            self.am.add_read(r.seq)
        contigs = self.am.assemble()
        inv_confirmed = False
        if contigs:
            contig = max(contigs, key=lambda c: len(c.seq))
            if len(contig.seq) >= 60:
                pad = 150
                w_lo = max(0, lo_p - pad)
                left = self.genome.fetch(chrom, w_lo, lo_p)
                seg = self.genome.fetch(chrom, lo_p, min(hi_p, lo_p + 2 * pad))
                inv_hap = left + _revcomp(seg)
                q = dna.fill_n(dna.encode(contig.seq))
                t = dna.fill_n(dna.encode(inv_hap))
                best_inv = max(
                    _dp(q, t, match=2, mismatch=-12, q=16, e=1,
                                   q2=32, e2=0, w=500, zdrop=-1).max,
                    _dp((q[::-1] ^ 3), t, match=2, mismatch=-12,
                                   q=16, e=1, q2=32, e2=0, w=500,
                                   zdrop=-1).max,
                )
                ref_hap = left + seg
                t2 = dna.fill_n(dna.encode(ref_hap))
                best_ref = max(
                    _dp(q, t2, match=2, mismatch=-12, q=16, e=1,
                                   q2=32, e2=0, w=500, zdrop=-1).max,
                    _dp((q[::-1] ^ 3), t2, match=2, mismatch=-12,
                                   q=16, e=1, q2=32, e2=0, w=500,
                                   zdrop=-1).max,
                )
                inv_confirmed = best_inv > best_ref + 8
        anchor0 = max(lo_p, 0)
        anchor = self.genome.fetch(chrom, anchor0, anchor0 + 1) or "N"
        info = {"SVTYPE": "INV", "END": str(hi_p + 1),
                "SVLEN": str(hi_p - lo_p)}
        if not inv_confirmed:
            info["IMPRECISE"] = True
        return VCFRecord(
            chrom=chrom, pos1=anchor0 + 1, id=f"nova.INV.{anchor0}",
            ref=anchor, alts=["<INV>"], qual=".", filter="PASS",
            info=info, format="GT:SR",
            samples=[f"./.:{n_support},0,0"],
        )

    # ------------------------------------------------------------------
    def _call_tra(self, sves: list[Sve], reads, chrom, chroms):
        """Inter-chromosomal breakends from the typed DR/TRA list,
        emitted as MATEID-mirrored BND record pairs."""
        o = self.o
        # cluster mate-pair evidence directly (the SVE election already
        # ran; refine junction with read-level data)
        cand = []
        for r in reads:
            if (r.is_unmapped or r.mate_unmapped or r.tid == r.mtid
                    or r.mtid < 0 or r.mapq < o.min_mapq
                    or r.is_reverse == r.mate_reverse):
                continue
            jpos = r.pos if r.is_reverse else r.end_pos
            cand.append((r.mtid, jpos, r.mpos, r))
        cand.sort(key=lambda t: (t[0], t[1]))
        clusters: list[list] = []
        for item in cand:
            if (clusters
                    and item[0] == clusters[-1][-1][0]
                    and item[1] - clusters[-1][-1][1] <= 150
                    and abs(item[2] - clusters[-1][-1][2]) <= 2 * o.isize_max):
                clusters[-1].append(item)
            else:
                clusters.append([item])
        for cl in clusters:
            if len(cl) < o.min_support:
                continue
            mtid = cl[0][0]
            bp0 = int(np.median([x[1] for x in cl]))
            mate_bp = int(np.median([x[2] for x in cl]))
            fwd = sum(1 for x in cl if not x[3].is_reverse)
            chrom2 = chroms[mtid]
            rightward = fwd * 2 >= len(cl)
            if rightward:
                # t[p[ : junction after the anchored base
                anchor0 = max(bp0 - 1, 0)
            else:
                # ]p]t : junction base is the first aligned base
                anchor0 = bp0
            anchor = self.genome.fetch(chrom, anchor0, anchor0 + 1) or "N"
            mate_anchor = self.genome.fetch(chrom2, mate_bp, mate_bp + 1) \
                or "N"
            id1 = f"nova.BND.{chrom}.{anchor0}"
            id2 = f"nova.BND.{chrom2}.{mate_bp}"
            if rightward:
                alt1 = f"{anchor}[{chrom2}:{mate_bp + 1}["
                alt2 = f"]{chrom}:{anchor0 + 1}]{mate_anchor}"
            else:
                alt1 = f"]{chrom2}:{mate_bp + 1}]{anchor}"
                alt2 = f"{mate_anchor}[{chrom}:{anchor0 + 1}["
            common = {"SVTYPE": "BND", "IMPRECISE": True}
            yield VCFRecord(
                chrom=chrom, pos1=anchor0 + 1, id=id1,
                ref=anchor, alts=[alt1], qual=".", filter="PASS",
                info={**common, "CHR2": chrom2, "END": str(mate_bp + 1),
                      "MATEID": id2},
                format="GT:SR", samples=[f"./.:{len(cl)},0,0"],
            )
            yield VCFRecord(
                chrom=chrom2, pos1=mate_bp + 1, id=id2,
                ref=mate_anchor, alts=[alt2], qual=".", filter="PASS",
                info={**common, "CHR2": chrom, "END": str(anchor0 + 1),
                      "MATEID": id1},
                format="GT:SR", samples=[f"./.:{len(cl)},0,0"],
            )

    # ------------------------------------------------------------------
    def _resolve_ins_two_sided(self, support, chrom, dr_del_votes):
        """Two-sided clip assembly for long insertions (prefix from
        right-clip tails, suffix from left-clip heads, overlap-join)."""
        o = self.o
        right = [r for r in support if r.soft_right >= o.min_clip]
        left = [r for r in support if r.soft_left >= o.min_clip]
        if not right or not left:
            return None
        if dr_del_votes >= o.min_support:
            return None

        def consensus(coords):
            best_bp = best_n = 0
            for c in set(coords):
                n = sum(1 for x in coords if abs(x - c) <= 10)
                if n > best_n or (n == best_n and c < best_bp):
                    best_bp, best_n = c, n
            return best_bp, best_n

        bp_r, n_r = consensus([r.end_pos for r in right])
        bp_l, n_l = consensus([r.pos for r in left])
        if abs(bp_r - bp_l) > 20:
            return None
        best_n = n_r + n_l
        if best_n < o.min_support:
            return None
        bp0 = bp_r
        tails = [r.seq[len(r.seq) - r.soft_right :]
                 for r in right if abs(r.end_pos - bp0) <= 10]
        heads = [r.seq[: r.soft_left]
                 for r in left if abs(r.pos - bp0) <= 10]

        def column_vote(parts, end_anchored):
            if not parts:
                return ""
            width = max(len(p) for p in parts)
            out = []
            for i in range(width):
                col = {}
                for p in parts:
                    if i < len(p):
                        ch = p[len(p) - 1 - i] if end_anchored else p[i]
                        col[ch] = col.get(ch, 0) + 1
                ch, n = max(col.items(), key=lambda kv: kv[1])
                if n < 2:
                    break
                out.append(ch)
            s = "".join(out)
            return s[::-1] if end_anchored else s

        pre = column_vote(tails, end_anchored=False)
        suf = column_vote(heads, end_anchored=True)
        ins_seq = None
        if pre and suf:
            for k in range(min(len(pre), len(suf)), 19, -1):
                if pre[len(pre) - k :] == suf[:k]:
                    ins_seq = pre + suf[k:]
                    break
        n_alt = best_n
        anchor0 = max(bp0 - 1, 0)
        anchor = self.genome.fetch(chrom, anchor0, anchor0 + 1) or "N"
        if ins_seq is not None and len(ins_seq) >= o.min_sv_len:
            info = {"SVTYPE": "INS", "END": str(bp0),
                    "SVLEN": str(len(ins_seq))}
            alt = anchor + ins_seq
        else:
            est = len(pre) + len(suf)
            if est < o.min_sv_len:
                return None
            info = {"SVTYPE": "INS", "END": str(bp0), "SVLEN": str(est),
                    "IMPRECISE": True}
            alt = "<INS>"
        return VCFRecord(
            chrom=chrom, pos1=anchor0 + 1, id=f"nova.INS.{anchor0}",
            ref=anchor, alts=[alt], qual=".", filter="PASS",
            info=info, format="GT:SR", samples=[f"./.:{n_alt},0,0"],
        )

    # ------------------------------------------------------------------
    # Genotyping re-aligner (NOVA_SV_FINAL_RST_item::genotyping,
    # NovaSVRst.hpp:766-905 + Genotyping_read_aligner profile 2/6/24,2/
    # 32,1 band 30 zdrop 62, NovaSVRst.hpp:208-218)
    # ------------------------------------------------------------------
    MATCH, MISMATCH = 2, 6

    def _read_vs_contig_score(self, read_codes, contig_codes, st):
        """get_contig_alignment_score_core: clamp to contig bounds (skip
        regions), simple mismatch fast path (<6 wrong), else banded DP
        extension score (mqe)."""
        skip_left = 0
        if st < 0:
            skip_left = -st
            st = 0
        qlen = len(read_codes) - skip_left
        if qlen <= 0:
            return 0, skip_left, 0
        skip_right = max(st + qlen - len(contig_codes), 0)
        tlen = min(len(contig_codes) - st, qlen)
        if tlen <= 0:
            return 0, skip_left, skip_right
        q = read_codes[skip_left:]
        search = min(len(q), tlen)
        wrong = int(np.count_nonzero(
            q[:search] != contig_codes[st : st + search]))
        if wrong < 6:
            sc = (search - wrong) * self.MATCH - wrong * self.MISMATCH
            return sc, skip_left, skip_right
        ez = _dp(
            q, contig_codes[st : st + tlen],
            match=self.MATCH, mismatch=-self.MISMATCH,
            q=24, e=2, q2=32, e2=1, w=30, zdrop=62,
        )
        sc = max(0, ez.mqe if ez.mqe != ksw2_ref.NEG_INF else 0)
        return sc, skip_left, skip_right

    def _gap_penalty(self, n):
        return min(24 + n * 2, 32 + n * 1)

    def _read_vs_ref_score(self, r: BamRecord, chrom, skip_left,
                           skip_right):
        """getScoreByCigar_with_skip_region: score the ORIGINAL
        alignment against the actual reference within the non-skip
        read boundary (NovaSVRst.hpp:100-140)."""
        rcodes = dna.fill_n(dna.encode(r.seq))
        lb = skip_left
        rb = r.query_len - skip_right
        score = 0
        qi = 0
        tp = r.pos
        for op, ln in r.cigar:
            if op in ("M", "=", "X"):
                ref = dna.fill_n(dna.encode(
                    self.genome.fetch(chrom, tp, tp + ln)))
                n = min(ln, len(ref))
                match = mism = 0
                for k in range(n):
                    if not (lb <= qi + k < rb):
                        continue
                    if qi + k >= len(rcodes):
                        break
                    if rcodes[qi + k] == ref[k]:
                        match += 1
                    else:
                        mism += 1
                score += match * self.MATCH - mism * self.MISMATCH
                qi += ln
                tp += ln
            elif op in ("I", "S", "H"):
                inside = sum(1 for k in range(ln) if lb <= qi + k < rb)
                if inside:
                    score -= self._gap_penalty(inside)
                qi += ln
            elif op in ("D", "N"):
                if lb <= qi < rb:
                    score -= self._gap_penalty(ln)
                tp += ln
        return max(0, score)

    def _genotype(self, rec: VCFRecord, reads, chrom):
        o = self.o
        contig_seq = getattr(rec, "_contig", None)
        if contig_seq is None:
            return
        contig_ref_pos = getattr(rec, "_contig_ref_pos", 0)
        contig_codes = dna.fill_n(dna.encode(contig_seq))
        svlen = int(rec.info.get("SVLEN", 0) or 0)
        bp1 = rec.pos1 - 1
        try:
            end = int(rec.info.get("END", rec.pos1))
        except (TypeError, ValueError):
            end = rec.pos1
        bp2 = max(end - 1, bp1)
        edge = o.read_len
        # contig global positions for the two breakpoint anchorings:
        # reads left of the SV use contig_pos_bp1; reads right of it see
        # the contig shifted by the SV length
        contig_pos_bp1 = contig_ref_pos
        contig_pos_bp2 = contig_ref_pos - svlen
        regions = [(bp1, bp1)]
        region_is_overlap = bp2 - 10 <= bp1 + edge
        if not region_is_overlap:
            regions.append((bp2, bp2))

        n_alt = n_ref = n_unk = 0
        for ri, (bp, _) in enumerate(regions):
            for r in reads:
                if r.is_unmapped or r.is_secondary or r.is_supplementary:
                    continue
                read_st = r.pos - r.soft_left
                over1 = read_st <= bp1 < read_st + o.read_len
                over2 = read_st <= bp2 < read_st + o.read_len
                if region_is_overlap:
                    if not (over1 or over2):
                        continue
                elif ri == 0 and not over1:
                    continue
                elif ri == 1 and not over2:
                    continue
                if not region_is_overlap and ri == 0 and over1 and over2 \
                        and len(regions) > 1:
                    # counted once per overlapping region like the
                    # reference's per-region loops
                    pass
                rcodes = dna.fill_n(dna.encode(r.seq))
                true_ed = r.end_pos + r.soft_right
                cands = []
                for cp in ((contig_pos_bp1, contig_pos_bp2)
                           if over1 and over2 else
                           ((contig_pos_bp1,) if over1
                            else (contig_pos_bp2,))):
                    cands.append(read_st - cp)
                    cands.append((true_ed - r.query_len) - cp)
                best = (-1, 0, 0)
                for st in dict.fromkeys(cands):
                    sc, skl, skr = self._read_vs_contig_score(
                        rcodes, contig_codes, st)
                    if sc > best[0]:
                        best = (sc, skl, skr)
                sc_c, skl, skr = best
                sc_r = self._read_vs_ref_score(r, chrom, skl, skr)
                usable = r.query_len - skl - skr
                min_score = max(50 * self.MATCH,
                                (usable - 80) * self.MATCH)
                if sc_c > sc_r + 4 and sc_c > min_score:
                    n_alt += 1
                elif sc_c + 4 < sc_r and sc_r > min_score:
                    n_ref += 1
                else:
                    n_unk += 1
        # signal-number adjustment (NovaSVRst.hpp:885-889)
        alt_adj = n_alt / 1.5 if svlen > 0 else n_alt
        ref_adj = n_ref / 1.5 if svlen < 0 else n_ref
        if alt_adj > ref_adj * 3:
            gt = "1/1"
        elif alt_adj * 3 < ref_adj:
            gt = "0/0"
        else:
            gt = "0/1"
        if (alt_adj + ref_adj) * 3 < n_unk:
            gt = "0/0"
        rec.samples = [f"{gt}:{n_alt},{n_ref},{n_unk}"]
        if gt == "0/0":
            rec.filter = "LOW_DEPTH"


def _revcomp(s: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
            "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}
    return "".join(comp.get(c, "N") for c in reversed(s))


def _dedupe_by_proximity(records: list[VCFRecord]) -> list[VCFRecord]:
    """Drop same-type calls within 20 bp of an already-kept call on the
    same chromosome (overlapping-block re-calls with small median
    shifts), without collapsing genuinely distinct nearby SVs of
    different types."""
    kept: dict[tuple, list[int]] = {}
    out = []
    dup_spans: dict[str, list[tuple[int, int]]] = {}
    for r in sorted(records, key=lambda r: (r.chrom, r.pos1)):
        if r.sv_type == "DUP":
            try:
                dup_spans.setdefault(r.chrom, []).append(
                    (r.pos1, int(r.info.get("END", r.pos1))))
            except (TypeError, ValueError):
                pass
    for r in sorted(records, key=lambda r: (r.chrom, r.pos1)):
        key = (r.chrom, r.sv_type)
        positions = kept.setdefault(key, [])
        if positions and abs(positions[-1] - r.pos1) <= 20:
            continue
        # an INS at either breakpoint of a kept DUP is the same tandem
        # event seen from the other side — suppress the echo
        if r.sv_type == "INS" and any(
            abs(r.pos1 - lo) <= 20 or abs(r.pos1 - hi) <= 20
            for lo, hi in dup_spans.get(r.chrom, ())
        ):
            continue
        positions.append(r.pos1)
        out.append(r)
    return out
