"""BGZF (blocked gzip) reader/writer.

Replaces htslib's bgzf layer for BAM files. Pure Python over zlib;
block-level parallel compression is handled by the native C++ codec in
native/ when built (see io/bam.py), this module is the portable
fallback and the format reference.
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK = 65536


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block (data must be < 64 KiB)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1  # header(18) + footer(8) minus... computed:
    # header 12 + XLEN 6 = 18; footer 8; total = 18 + len(cdata) + 8
    bsize = 18 + len(cdata) + 8
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 0x08, 0x04,   # magic, deflate, FEXTRA
        0,                         # mtime
        0, 0xFF,                   # XFL, OS
        6,                         # XLEN
        66, 67,                    # 'B', 'C'
        2,                         # subfield length
        bsize - 1,                 # BSIZE - 1
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + footer


class BGZFWriter:
    """Buffers whole batches and compresses them with the native
    multithreaded codec (native/bgzf_codec.cpp; required: a missing
    library raises), single-threaded zlib only for a buffer the codec
    refuses."""

    def __init__(self, path_or_fh, level: int = 6, batch_bytes: int = 8 << 20):
        self._own = isinstance(path_or_fh, str)
        self._fh = open(path_or_fh, "wb") if self._own else path_or_fh
        self._buf = bytearray()
        self.level = level
        self.batch_bytes = batch_bytes

    def write(self, data: bytes) -> None:
        self._buf += data
        if len(self._buf) >= self.batch_bytes:
            self._flush(len(self._buf))

    def _flush(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        from . import native_bgzf

        out = native_bgzf.compress(chunk, self.level)
        if out is not None:
            self._fh.write(out)
            return
        for i in range(0, len(chunk), 65000):
            self._fh.write(compress_block(chunk[i : i + 65000], self.level))

    def close(self) -> None:
        if self._buf:
            self._flush(len(self._buf))
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BGZFReader:
    """Streaming reader; BGZF is valid multi-member gzip, decoded block
    by block so virtual offsets could be supported later."""

    def __init__(self, path_or_fh):
        self._own = isinstance(path_or_fh, str)
        self._fh = open(path_or_fh, "rb") if self._own else path_or_fh
        self._buf = bytearray()
        self._carry = b""   # partial compressed block (native chunk path)
        self._eof = False
        self.uoffset = 0   # uncompressed bytes handed out so far

    def _read_block(self) -> bool:
        header = self._fh.read(18)
        if len(header) < 18:
            self._eof = True
            return False
        if header[0] != 0x1F or header[1] != 0x8B:
            raise ValueError("not a BGZF block")
        bsize = struct.unpack("<H", header[16:18])[0] + 1
        rest = self._fh.read(bsize - 18)
        cdata = rest[:-8]
        isize = struct.unpack("<I", rest[-4:])[0]
        data = zlib.decompress(cdata, -15)
        if len(data) != isize:
            raise ValueError("BGZF ISIZE mismatch")
        self._buf += data
        return True

    def read(self, n: int) -> bytes:
        if self._carry:
            # un-consume the native chunk path's partial block so the
            # block-at-a-time path sees a consistent stream
            self._fh.seek(-len(self._carry), 1)
            self._carry = b""
        while len(self._buf) < n and not self._eof:
            self._read_block()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        self.uoffset += len(out)
        return out

    def next_chunk(self) -> bytes | None:
        """Drain the buffered decompressed bytes (or the next block(s))
        as one chunk — the zero-compaction path for record streaming
        (read() pays an O(buffer) bytearray delete per call). With the
        native codec built, many blocks decompress per call on a thread
        pool."""
        if self._buf:
            out = bytes(self._buf)
            self._buf.clear()
            self.uoffset += len(out)
            return out
        from . import native_bgzf

        if native_bgzf.available():
            while True:
                out = self._next_chunk_native()
                if out is None or out:
                    return out  # EOF or real payload (skip empty blocks)
        if not self._read_block():
            return None
        out = bytes(self._buf)
        self._buf.clear()
        self.uoffset += len(out)
        return out

    def _next_chunk_native(self, target: int = 4 << 20) -> bytes | None:
        """Read up to ~target compressed bytes of whole blocks and
        decompress them in parallel via the native codec."""
        from . import native_bgzf

        data = self._carry + self._fh.read(max(target - len(self._carry),
                                               65536))
        if not data:
            self._eof = True
            return None
        offs = []
        lens = []
        p = 0
        n = len(data)
        while p + 18 <= n:
            if data[p] != 0x1F or data[p + 1] != 0x8B:
                raise ValueError("not a BGZF block")
            bsize = struct.unpack_from("<H", data, p + 16)[0] + 1
            if p + bsize > n:
                break
            offs.append(p)
            lens.append(bsize)
            p += bsize
        self._carry = data[p:]
        if not offs:
            if len(self._carry) < 18:
                self._eof = True
                return None
            raise ValueError("oversized/truncated BGZF block")
        out = native_bgzf.decompress_blocks(data, offs, lens)
        if out is None:  # codec refused: fall back to the zlib path
            self._buf += b"".join(
                zlib.decompress(
                    data[o + 18 : o + l - 8], -15) for o, l in zip(offs, lens)
            )
            out = bytes(self._buf)
            self._buf.clear()
        self.uoffset += len(out)
        return out

    def read_all(self) -> bytes:
        while self._read_block():
            pass
        out = bytes(self._buf)
        self._buf.clear()
        return out

    def close(self):
        if self._own:
            self._fh.close()
