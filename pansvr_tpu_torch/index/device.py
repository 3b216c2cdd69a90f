"""Device-resident form of the RdBG index as PyTorch tensors.

Port of pansvr_tpu/index/device.py: the same flat int32 arrays built
from the same host ``RdBGIndex``, padded to the same power-of-two sizes
(every clip bound the seeding stages apply therefore matches the JAX
package's), with unitig/reference sequences packed 16 bases per 32-bit
word, MSB-first.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .builder import RdBGIndex

PAD_WORDS = 128  # zero words on both sides of uni_words_pad; must exceed
                 # the largest extension step count (99 for the 1600
                 # read class) so extension windows stay in bounds


def pack_u32(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> uint32 words, 16 bases/word, MSB-first (int32 view)."""
    n = len(codes)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = codes & 3
    mat = padded.reshape(n_words, 16)
    shifts = np.uint32(2) * (np.uint32(15) - np.arange(16, dtype=np.uint32))
    return (mat << shifts).sum(axis=1, dtype=np.uint32).view(np.int32)


def _pow2_len(n: int, min_size: int = 256) -> int:
    return max(min_size, 1 << max(n - 1, 0).bit_length())


def _pad_pow2(a: np.ndarray, fill, min_size: int = 256) -> np.ndarray:
    n = len(a)
    target = _pow2_len(n, min_size)
    if target == n:
        return a
    out = np.full(target, fill, a.dtype)
    out[:n] = a
    return out


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


_CHUNK = 1 << 20   # buckets or entries a step of to_device's host loops


def _entry_keys(hash_g: np.ndarray, keys: np.ndarray,
                out: np.ndarray) -> None:
    """out[e] = bucket << 32 | keys[e] for every entry e, its first-level
    bucket being the b with hash_g[b] <= e < hash_g[b + 1] (empty buckets
    hold none): the bucket-start expansion np.repeat(np.arange(4^fl),
    np.diff(hash_g)), a block of buckets at a time, so the host never
    holds an array of the table's 4^fl + 1 entries (at first level 14
    that expansion took ~5 GiB of int64 temporaries)."""
    base = int(hash_g[0])
    nb = len(hash_g) - 1
    for st in range(0, nb, _CHUNK):
        h = hash_g[st:min(st + _CHUNK, nb) + 1]
        lo, hi = int(h[0]) - base, int(h[-1]) - base
        if lo == hi:
            continue
        cnt = np.diff(h)
        full = np.flatnonzero(cnt)
        b = np.repeat(full + st, cnt[full])
        b <<= 32
        b |= keys[lo:hi]
        out[lo:hi] = b


def _entry_unitigs(uni_seqf: np.ndarray, off_g: np.ndarray,
                   n_unitigs: int) -> np.ndarray:
    """The unitig of each entry's offset, clipped to [0, n_unitigs - 1]
    (int32): np.searchsorted(uni_seqf, off_g, side="right") - 1, read
    from a table of the unitig at each unitig-space position when every
    offset lies in that space (one gather a k-mer in place of a
    bisection)."""
    off = np.asarray(off_g)
    lo, hi = int(uni_seqf[0]), int(uni_seqf[-1])
    if len(off) and lo <= off.min() and off.max() < hi:
        uid_at = np.repeat(np.arange(len(uni_seqf) - 1, dtype=np.int32),
                           np.diff(uni_seqf))
        uid = uid_at[off - lo if lo else off]
    else:
        uid = (np.searchsorted(uni_seqf, off, side="right") - 1).astype(
            np.int32)
    return np.clip(uid, 0, max(n_unitigs - 1, 0), out=uid)


def to_device(idx: RdBGIndex, device="cuda") -> DeviceIndex:
    """The index tensors on `device` (default the card; a missing card
    raises, as the engine's device does; pass "cpu" for the plain path).
    The per-entry tables are filled in place, a block of entries at a
    time, so the host holds the padded tables and O(_CHUNK) temporaries
    beside one int32 unitig id per entry."""
    device = resolve_device(device)
    n_k = len(idx.kmer_g)
    n_pad = _pow2_len(n_k)
    uni_seqf = np.asarray(idx.uni_seqf, np.int64)
    uni_posp = np.asarray(idx.uni_posp, np.int64)
    ent_uid = _entry_unitigs(uni_seqf, idx.off_g, idx.n_unitigs)
    # rows: off_g, uid, off_l, min(off_r, 2047) | min(pos_n, 2^21-1) << 11
    ent_pack = np.zeros((n_pad, 4), np.int32)
    for lo in range(0, n_k, _CHUNK):
        hi = min(lo + _CHUNK, n_k)
        off = np.asarray(idx.off_g[lo:hi], np.int64)
        uid = ent_uid[lo:hi]
        off_r = uni_seqf[uid + 1] - off - idx.search_k
        pos_n = uni_posp[uid + 1] - uni_posp[uid]
        ent_pack[lo:hi, 0] = off
        ent_pack[lo:hi, 1] = uid
        ent_pack[lo:hi, 2] = off - uni_seqf[uid]
        ent_pack[lo:hi, 3] = np.minimum(off_r, 2047).astype(np.int32) | (
            np.minimum(pos_n, (1 << 21) - 1).astype(np.int32) << 11)
    del ent_uid
    # first-level bucket << 32 | search-k residue; pads sort last
    i32max = 0x7FFFFFFF
    ent_key = np.full(n_pad, (i32max << 32) | i32max, np.int64)
    keys = idx.kmer_g.view(np.int32) >> np.int32(2 * (idx.k - idx.search_k))
    _entry_keys(idx.hash_g, keys, ent_key)
    del keys
    # equal-key runs (a residue is < 2^31, so equal keys are equal
    # (bucket, residue) pairs); the count of a probe hit is ent_run at
    # its lower bound
    ent_run = np.zeros(n_pad, np.int32)
    if n_k:
        new_run = np.empty(n_k, bool)
        new_run[0] = True
        np.not_equal(ent_key[1:n_k], ent_key[:n_k - 1], out=new_run[1:])
        run_len = np.diff(np.append(np.flatnonzero(new_run), n_k))
        del new_run
        ent_run[:n_k] = np.repeat(run_len, run_len)
        del run_len
    packed_uni = np.where(idx.uni_codes >= 4, np.uint8(2), idx.uni_codes)
    packed_ref = np.where(idx.ref_codes >= 4, np.uint8(2), idx.ref_codes)
    pad = np.zeros(PAD_WORDS, np.int32)
    uni_words_pad = np.concatenate(
        [pad, _pad_pow2(pack_u32(packed_uni), 0), pad])
    posp = idx.uni_posp.astype(np.int32)
    posp_p = _pad_pow2(posp, posp[-1] if len(posp) else np.int32(0))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceIndex(
        search_k=idx.search_k, first_level_bases=idx.first_level_bases,
        n_kmer=len(ent_key), n_uni=len(posp_p) - 1,
        uni_posp=t(posp_p),
        uni_pos=t(_pad_pow2(idx.uni_pos.astype(np.int32), 0)),
        ref_words=t(_pad_pow2(pack_u32(packed_ref), 0)),
        ent_run=t(ent_run), ent_pack=t(ent_pack),
        ent_key=t(ent_key), uni_words_pad=t(uni_words_pad))
