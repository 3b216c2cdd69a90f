"""Device-resident form of the RdBG index as PyTorch tensors.

Port of pansvr_tpu/index/device.py: the same flat int32 arrays derived
from the same host ``RdBGIndex``, padded to the same power-of-two sizes
(every clip bound the seeding stages apply therefore matches the JAX
package's), with unitig/reference sequences packed 16 bases per 32-bit
word, MSB-first. The JAX package builds them on the host; here the
index's source arrays are streamed to the device and the tables derived
there, so the host holds none of them.
"""

from __future__ import annotations

import contextlib
import mmap
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import Spans
from .builder import RdBGIndex

PAD_WORDS = 128  # zero words on both sides of uni_words_pad; must exceed
                 # the largest extension step count (99 for the 1600
                 # read class) so extension windows stay in bounds


def _pow2_len(n: int, min_size: int = 256) -> int:
    return max(min_size, 1 << max(n - 1, 0).bit_length())


@dataclass(frozen=True)
class DeviceIndex:
    """The index tensors the front and the DP fill read (int32; ent_key
    int64) plus scalar metadata. n_kmer / n_uni are the padded sizes,
    the clip bounds of the JAX package's gathers."""
    search_k: int
    first_level_bases: int
    n_kmer: int
    n_uni: int
    uni_posp: torch.Tensor   # (n_uni + 1,) occurrence-list starts
    uni_pos: torch.Tensor    # (n_occ,) 0-based occurrence starts
    ref_words: torch.Tensor  # packed reference (N -> 2)
    ent_run: torch.Tensor    # equal-key run length at each run start
    # (n_kmer, 4) rows: off_g, uid, off_l, min(off_r, 2047) | min(pos_n,
    # 2^21 - 1) << 11 (the JAX package's ent_pack layout)
    ent_pack: torch.Tensor
    # first-level bucket << 32 | search-k residue per entry, sorted (pads
    # INT32_MAX << 32 | INT32_MAX sort last): the probe's searchsorted table
    ent_key: torch.Tensor
    uni_words_pad: torch.Tensor  # unitig words, PAD_WORDS zeros both ends


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device that is not there raises
    (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_guard(dev):
    """Context that makes CUDA device `dev` current (so launches, streams
    and events without an explicit device land on it); no-op on the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device` without a stream sync: staged
    through pinned memory (PyTorch's caching host allocator reuses the
    blocks once their copies are done) and copied non-blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# each of to_device's two host staging buffers: small, since PyTorch's
# caching host allocator keeps a pinned block resident for the life of
# the process
STAGE_BYTES = 8 << 20

# the RdBGIndex arrays the device tables derive from
SOURCES = ("hash_g", "kmer_g", "off_g", "uni_seqf", "uni_posp", "uni_pos",
           "uni_codes", "ref_codes")


def _npy_file(a: np.ndarray):
    """(path, byte offset of the data) of an array that maps a whole .npy
    file (np.load(..., mmap_mode="r"), as store.load_index opens the
    index), else None."""
    if isinstance(a, np.memmap) and isinstance(a.base, mmap.mmap) \
            and a.filename and a.flags.c_contiguous:
        return a.filename, a.offset
    return None


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    """The tensor dtype an array's bytes are staged as: its own, or the
    signed one of its width for a wider unsigned type (kmer_g's uint32
    residues are read as int32, as the JAX package views them)."""
    dt = np.dtype(dt)
    if dt.kind == "u" and dt.itemsize > 1:
        dt = np.dtype(f"i{dt.itemsize}")
    return torch.from_numpy(np.empty(0, dt)).dtype


class _Stager:
    """Host arrays -> tensors on `device`, STAGE_BYTES at a time through
    two host buffers taken in turns (pinned on a card, where each copy to
    the card is asynchronous and the buffer is reused once the event
    recorded behind it has passed). A whole-file memmap is read from its
    file with readinto, never through the mapping, so none of its pages
    enter the process's resident set; an array in memory is copied."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.events = [None, None]
        self.turn = 0
        self.bytes = 0

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        out = torch.empty(len(a), dtype=_torch_dtype(a.dtype),
                          device=self.device)
        dst = out.view(torch.uint8)
        n_bytes = dst.numel()
        path = _npy_file(a)
        with contextlib.ExitStack() as stack:
            if path is not None:
                fh = stack.enter_context(open(path[0], "rb", buffering=0))
                fh.seek(path[1])
            else:
                flat = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
            for pos in range(0, n_bytes, STAGE_BYTES):
                n = min(STAGE_BYTES, n_bytes - pos)
                i, self.turn = self.turn, self.turn ^ 1
                if self.events[i] is not None:
                    self.events[i].synchronize()
                buf = self.bufs[i][:n]
                if path is not None:
                    _read_exact(fh, buf.numpy())
                else:
                    np.copyto(buf.numpy(), flat[pos:pos + n])
                dst[pos:pos + n].copy_(buf, non_blocking=self.cuda)
                if self.cuda:
                    self.events[i] = torch.cuda.Event()
                    self.events[i].record()
        self.bytes += n_bytes
        return out


def _read_exact(fh, buf: np.ndarray) -> None:
    view = memoryview(buf)
    got = 0
    while got < len(view):
        n = fh.readinto(view[got:])
        if not n:
            raise EOFError(f"{fh.name}: {len(view) - got} bytes short")
        got += n


def _i32(t: torch.Tensor) -> torch.Tensor:
    """An integer tensor as int32, wrapped modulo 2^32 as NumPy's
    astype(np.int32) wraps."""
    if t.dtype == torch.int32:
        return t
    t = t.long()
    return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _padded(t: torch.Tensor, n_out: int, fill=0) -> torch.Tensor:
    """int32 of `t` in the first len(t) of n_out entries, `fill` after
    (a tensor fill is read on the device)."""
    out = torch.empty(n_out, dtype=torch.int32, device=t.device)
    out[:len(t)] = _i32(t)
    out[len(t):] = fill
    return out


def _words(codes: torch.Tensor) -> torch.Tensor:
    """2-bit codes (N and any code >= 4 -> 2) -> int32 words, 16 bases a
    word, MSB-first, the last word zero-filled."""
    n = len(codes)
    n_words = (n + 15) // 16
    c = torch.zeros(n_words * 16, dtype=torch.int64, device=codes.device)
    c[:n] = torch.where(codes >= 4, 2, codes) & 3
    shifts = torch.arange(30, -1, -2, dtype=torch.int64, device=codes.device)
    return _i32((c.view(n_words, 16) << shifts).sum(1))


def to_device(idx: RdBGIndex, device="cuda", tr: Spans | None = None
              ) -> DeviceIndex:
    """The index tensors on `device` (default the card; a missing card
    raises, as the engine's device does; pass "cpu" for the plain path).

    The source arrays (SOURCES) are streamed to the device through two
    STAGE_BYTES host buffers, read from the store's files where they are
    mapped (the mappings are never touched), and every table is derived
    on the device: the host holds no table of the padded entry count.
    Spans of `tr` (the engine's recorder): `index_read` (the reads and the
    waits for a free buffer; counters index_read_s, and index_read_bytes
    the source arrays' bytes) and `index_derive` (the derivation through
    one final synchronisation, so the tables are ready when it returns;
    index_derive_s)."""
    device = resolve_device(device)
    tr = tr or Spans(defaultdict(float))
    with device_guard(device):
        with tr.span("index_read", "index_read_s"):
            st = _Stager(device)
            src = {f: st.tensor(getattr(idx, f)) for f in SOURCES}
        tr.prof["index_read_bytes"] += st.bytes
        del st
        with tr.span("index_derive", "index_derive_s"):
            didx = _derive(idx, src)
            del src
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
    return didx


def _derive(idx: RdBGIndex, src: dict) -> DeviceIndex:
    """The tables from the source tensors `src` (popped as they are used),
    on their device."""
    hash_g, kmer_g = src.pop("hash_g"), src.pop("kmer_g")
    dev = hash_g.device
    n_k = len(kmer_g)
    n_pad = _pow2_len(n_k)
    # first-level bucket << 32 | search-k residue; pads sort last. An
    # entry e lies in the bucket b with hash_g[b] <= e + hash_g[0] <
    # hash_g[b + 1] (empty buckets hold none)
    i32max = 0x7FFFFFFF
    ent_key = torch.full((n_pad,), (i32max << 32) | i32max,
                         dtype=torch.int64, device=dev)
    ent_run = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    if n_k:
        e = torch.arange(n_k, dtype=torch.int32, device=dev) + hash_g[:1]
        bucket = torch.searchsorted(hash_g, e, right=True, out_int32=True)
        del e, hash_g
        bucket -= 1
        keys = kmer_g >> 2 * (idx.k - idx.search_k)
        del kmer_g
        ent_key[:n_k] = bucket.long() << 32 | keys.long()
        del bucket, keys
        # equal-key runs (a residue is < 2^31, so equal keys are equal
        # (bucket, residue) pairs); the count of a probe hit is ent_run
        # at its lower bound
        counts = torch.unique_consecutive(ent_key[:n_k],
                                          return_counts=True)[1]
        ent_run[:n_k] = torch.repeat_interleave(counts, counts,
                                                output_size=n_k)
        del counts
    # rows: off_g, uid, off_l, min(off_r, 2047) | min(pos_n, 2^21-1) << 11
    off = src.pop("off_g").long()
    seqf = src.pop("uni_seqf").long()
    posp = src.pop("uni_posp")
    ent_pack = torch.zeros((n_pad, 4), dtype=torch.int32, device=dev)
    if n_k:
        uid = torch.searchsorted(seqf, off, right=True) - 1
        uid.clamp_(0, max(idx.n_unitigs - 1, 0))
        ent_pack[:n_k, 0] = _i32(off)
        ent_pack[:n_k, 1] = _i32(uid)
        ent_pack[:n_k, 2] = _i32(off - seqf[uid])
        off_r = (seqf[uid + 1] - off - idx.search_k).clamp_(max=2047)
        pos_n = posp[uid + 1].long() - posp[uid]
        del uid, off
        ent_pack[:n_k, 3] = _i32(off_r | pos_n.clamp_(max=(1 << 21) - 1)
                                 << 11)
        del off_r, pos_n
    del seqf
    # uni_posp pads repeat its last value (pad unitigs hold no
    # occurrence), the other tables pad with 0
    n_posp = len(posp)
    uni_posp = _padded(posp, _pow2_len(n_posp),
                       _i32(posp[-1:]) if n_posp else 0)
    del posp
    uni_pos = src.pop("uni_pos")
    uni_pos = _padded(uni_pos, _pow2_len(len(uni_pos)))
    uni = _words(src.pop("uni_codes"))
    uni_words_pad = torch.zeros(2 * PAD_WORDS + _pow2_len(len(uni)),
                                dtype=torch.int32, device=dev)
    uni_words_pad[PAD_WORDS:PAD_WORDS + len(uni)] = uni
    del uni
    ref = _words(src.pop("ref_codes"))
    ref_words = _padded(ref, _pow2_len(len(ref)))
    return DeviceIndex(
        search_k=idx.search_k, first_level_bases=idx.first_level_bases,
        n_kmer=n_pad, n_uni=len(uni_posp) - 1, uni_posp=uni_posp,
        uni_pos=uni_pos, ref_words=ref_words, ent_run=ent_run,
        ent_pack=ent_pack, ent_key=ent_key, uni_words_pad=uni_words_pad)
