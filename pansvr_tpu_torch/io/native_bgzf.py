"""ctypes binding for the native multithreaded BGZF codec
(native/bgzf_codec.cpp); io.bgzf uses it for whole-buffer compression
and many-block decompression. The library (native/build/, built by
tools/build_native.sh) is required: get_lib raises when it is missing or
does not load, so a BAM is never written by the slow zlib path unawares."""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build", "libpansvr_bgzf.so",
)

_lib = None


def load_required(path: str, what: str):
    """ctypes.CDLL(path), raising RuntimeError when the library is missing
    or does not load."""
    if not os.path.exists(path):
        raise RuntimeError(f"the native {what} library {path} is missing "
                           "(build it with tools/build_native.sh)")
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"the native {what} library {path} does not "
                           f"load: {e}") from e


def available() -> bool:
    return get_lib() is not None


def get_lib():
    global _lib
    if _lib is None:
        lib = load_required(_LIB_PATH, "BGZF codec")
        lib.bgzf_compress_blocks.restype = ctypes.c_int
        lib.bgzf_decompress_blocks.restype = ctypes.c_int
        if hasattr(lib, "bgzf_decompress_blocks_at"):
            lib.bgzf_decompress_blocks_at.restype = ctypes.c_int
        _lib = lib
    return _lib


def decompress_blocks(data, offs, lens, n_threads: int = 8) -> bytes | None:
    """Decompress many BGZF blocks (extents into `data`) in parallel;
    returns the concatenated payload, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(offs)
    if n == 0:
        return b""
    src = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offs, np.int64)
    lens_a = np.ascontiguousarray(lens, np.int32)
    if hasattr(lib, "bgzf_decompress_blocks_at"):
        # destination offsets from the ISIZE trailers (last 4 bytes of
        # each block): exact-size output, zero re-concatenation — the
        # strided variant below over-allocates 64 KiB per block, which
        # is pathological on record-per-block writers
        tail = (offsets + lens_a - 4).astype(np.int64)
        isz = (
            src[tail].astype(np.int64)
            | (src[tail + 1].astype(np.int64) << 8)
            | (src[tail + 2].astype(np.int64) << 16)
            | (src[tail + 3].astype(np.int64) << 24)
        )
        dst_offs = np.zeros(n + 1, np.int64)
        np.cumsum(isz, out=dst_offs[1:])
        dst = np.empty(int(dst_offs[-1]), dtype=np.uint8)
        rc = lib.bgzf_decompress_blocks_at(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int(n), ctypes.c_int(n_threads),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dst_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc < 0:
            return None
        return dst.tobytes()
    dst = np.empty(n * 65536, dtype=np.uint8)
    dst_lens = np.empty(n, dtype=np.int32)
    rc = lib.bgzf_decompress_blocks(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n), ctypes.c_int(n_threads),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        return None
    out = np.concatenate(
        [dst[i * 65536 : i * 65536 + dst_lens[i]] for i in range(n)])
    return out.tobytes()


def compress(data: bytes, level: int = 6, n_threads: int = 8,
             block_size: int = 65000) -> bytes | None:
    """Compress a byte buffer into concatenated BGZF blocks in parallel.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return b""
    n_blocks = (n + block_size - 1) // block_size
    src = np.frombuffer(data, dtype=np.uint8)
    offsets = (np.arange(n_blocks, dtype=np.int64) * block_size)
    lens = np.full(n_blocks, block_size, dtype=np.int32)
    lens[-1] = n - (n_blocks - 1) * block_size
    dst = np.empty(n_blocks * 65536, dtype=np.uint8)
    dst_lens = np.empty(n_blocks, dtype=np.int32)
    rc = lib.bgzf_compress_blocks(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n_blocks), ctypes.c_int(level), ctypes.c_int(n_threads),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        return None
    parts = [
        dst[i * 65536 : i * 65536 + dst_lens[i]].tobytes()
        for i in range(n_blocks)
    ]
    return b"".join(parts)
