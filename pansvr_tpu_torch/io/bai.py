"""BAM sorting + BAI index construction (htslib-free).

The reference's fc_sv stage iterates BAM regions through an index
(signalSAMLoader resetRegion_ID -> sam_itr_queryi), so interop with the
reference binaries needs position-sorted BAMs with .bai files. This
module sorts in memory (our realigned BAMs are signal-read sized) and
builds the standard BAI: per-reference binning index (reg2bin chunks)
plus the 16 kb linear index, with BGZF virtual offsets recovered by
walking the block table of the finished file.
"""

from __future__ import annotations

import struct
import zlib

from .bam import BamReader, BamWriter

BAI_MAGIC = b"BAI\1"


def reg2bin(beg: int, end: int) -> int:
    """SAM spec reg2bin (0-based, end exclusive -> end-1 inclusive)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _sort_key(r):
    return (r.tid if r.tid >= 0 else 1 << 30, r.pos)


def sort_bam(in_path: str, out_path: str,
             max_records_in_ram: int | None = None) -> None:
    """Position-sort (tid, pos) into a new BAM.

    With max_records_in_ram set, runs as an external merge sort (the
    samtools-sort analog in the reference driver, panSVR_run.sh:53):
    sorted runs are spilled to temp BAMs and k-way merged, so a 30x WGS
    realigned output sorts in bounded memory."""
    import heapq
    import os as _os
    import tempfile

    with BamReader(in_path) as rd:
        header = rd.header
        text = header.text
        if "SO:" in text:
            header.text = text.replace("SO:unsorted", "SO:coordinate")

        import struct as _struct

        _tp = _struct.Struct("<ii").unpack_from

        def body_key(body):
            tid, pos = _tp(body, 0)
            return (tid if tid >= 0 else 1 << 30, pos)

        # raw-body sort: records never decode/re-encode — keys read at
        # fixed offsets, bodies pass straight through to the writer
        if max_records_in_ram is None:
            bodies = list(rd.iter_bodies())
            bodies.sort(key=body_key)
            with BamWriter(out_path, header) as w:
                for b in bodies:
                    w.write_raw(b)
            return

        tmpdir = tempfile.mkdtemp(prefix="bamsort_")
        runs = []
        try:
            buf = []
            for b in rd.iter_bodies():
                buf.append(b)
                if len(buf) >= max_records_in_ram:
                    buf.sort(key=body_key)
                    p = _os.path.join(tmpdir, f"run{len(runs)}.bam")
                    with BamWriter(p, header) as w:
                        for x in buf:
                            w.write_raw(x)
                    runs.append(p)
                    buf = []
            buf.sort(key=body_key)
            if not runs:
                with BamWriter(out_path, header) as w:
                    for x in buf:
                        w.write_raw(x)
                return
            if buf:
                p = _os.path.join(tmpdir, f"run{len(runs)}.bam")
                with BamWriter(p, header) as w:
                    for x in buf:
                        w.write_raw(x)
                runs.append(p)
            readers = [BamReader(p) for p in runs]
            streams = [rr.iter_bodies() for rr in readers]
            with BamWriter(out_path, header) as w:
                for b in heapq.merge(*streams, key=body_key):
                    w.write_raw(b)
            for rr in readers:
                rr.close()
        finally:
            for p in runs:
                try:
                    _os.unlink(p)
                except OSError:
                    pass
            try:
                _os.rmdir(tmpdir)
            except OSError:
                pass


def _block_table(path: str):
    """[(file_offset, uncompressed_start, uncompressed_len)] per block."""
    table = []
    upos = 0
    with open(path, "rb") as fh:
        while True:
            foff = fh.tell()
            header = fh.read(18)
            if len(header) < 18:
                break
            bsize = struct.unpack("<H", header[16:18])[0] + 1
            rest = fh.read(bsize - 18)
            isize = struct.unpack("<I", rest[-4:])[0]
            table.append((foff, upos, isize))
            upos += isize
    return table


def _voffset(table, uoff: int) -> int:
    """Uncompressed stream offset -> BGZF virtual offset."""
    lo, hi = 0, len(table) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if table[mid][1] <= uoff:
            lo = mid
        else:
            hi = mid - 1
    foff, ustart, _ = table[lo]
    return (foff << 16) | (uoff - ustart)


def build_bai(bam_path: str, bai_path: str | None = None) -> str:
    """Build the .bai for a position-sorted BAM.

    Streams the file block-by-block (memory O(window), not O(file)),
    tracking each record's absolute uncompressed offset for the virtual
    file offsets."""
    from .bgzf import BGZFReader

    bai_path = bai_path or bam_path + ".bai"
    table = _block_table(bam_path)

    rd = BGZFReader(bam_path)
    if rd.read(4) != b"BAM\1":
        raise ValueError(f"not a BAM file: {bam_path}")
    l_text = struct.unpack("<i", rd.read(4))[0]
    rd.read(l_text)
    n_ref = struct.unpack("<i", rd.read(4))[0]
    for _ in range(n_ref):
        l_name = struct.unpack("<i", rd.read(4))[0]
        rd.read(l_name + 4)

    # per-reference indices
    bins: list[dict[int, list]] = [dict() for _ in range(n_ref)]
    linear: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    n_no_coor = 0
    buf = b""
    pos = 0
    base_u = rd.uoffset  # absolute uncompressed offset of buf[0]

    def _ensure(n: int) -> bool:
        nonlocal buf, pos, base_u
        while len(buf) - pos < n:
            nb = rd.next_chunk()
            if nb is None:
                return False
            buf = buf[pos:] + nb
            base_u += pos
            pos = 0
        return True

    while _ensure(4):
        sz = struct.unpack_from("<I", buf, pos)[0]
        if not _ensure(4 + sz):
            break
        rec_u_start = base_u + pos
        body = buf[pos + 4 : pos + 4 + sz]
        pos += 4 + sz
        if len(body) < 32:
            break
        tid, pos_, l_name, _mq, _bin, n_cigar, _flag, l_seq, _mt, _mp, _is = \
            struct.unpack_from("<iiBBHHHiiii", body, 0)
        if tid < 0 or pos_ < 0:
            n_no_coor += 1
            continue
        # reference span from cigar
        cig_off = 32 + l_name
        ref_len = 0
        for k in range(n_cigar):
            v = struct.unpack_from("<I", body, cig_off + 4 * k)[0]
            op = v & 0xF
            if op in (0, 2, 3, 7, 8):  # M D N = X
                ref_len += v >> 4
        end = pos_ + max(ref_len, 1)
        v_start = _voffset(table, rec_u_start)
        v_end = _voffset(table, base_u + pos)
        b = reg2bin(pos_, end)
        chunks = bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for win in range(pos_ >> 14, ((end - 1) >> 14) + 1):
            cur = linear[tid].get(win)
            if cur is None or v_start < cur:
                linear[tid][win] = v_start
    rd.close()

    with open(bai_path, "wb") as out_fh:
        out_fh.write(BAI_MAGIC)
        out_fh.write(struct.pack("<i", n_ref))
        for tid in range(n_ref):
            out_fh.write(struct.pack("<i", len(bins[tid])))
            for b, chunks in sorted(bins[tid].items()):
                out_fh.write(struct.pack("<Ii", b, len(chunks)))
                for beg, end_ in chunks:
                    out_fh.write(struct.pack("<QQ", beg, end_))
            if linear[tid]:
                n_intv = max(linear[tid]) + 1
                # fill gaps with the previous window's offset
                arr = []
                prev = 0
                for w in range(n_intv):
                    prev = linear[tid].get(w, prev)
                    arr.append(prev)
            else:
                n_intv = 0
                arr = []
            out_fh.write(struct.pack("<i", n_intv))
            for v in arr:
                out_fh.write(struct.pack("<Q", v))
    return bai_path
