"""BGZF (blocked gzip) reader/writer.

Replaces htslib's bgzf layer for BAM files. Compression and many-block
decompression go through the native C++ codec in native/ (required: a
missing library or a codec error raises, there is no zlib fallback);
read() and read_all() decode block by block with zlib.
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK = 65536


class BGZFWriter:
    """Buffers whole batches and compresses them with the native
    multithreaded codec (native/bgzf_codec.cpp; required: a missing
    library or a codec error raises)."""

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

        self._fh.write(native_bgzf.compress(chunk, self.level))

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
        (read() pays an O(buffer) bytearray delete per call). Many blocks
        decompress per call on the native codec's thread pool."""
        if self._buf:
            out = bytes(self._buf)
            self._buf.clear()
            self.uoffset += len(out)
            return out
        while True:
            out = self._next_chunk_native()
            if out is None or out:
                return out  # EOF or real payload (skip empty blocks)

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
