"""Device-resident form of the RdBG index as PyTorch tensors.

Port of pansvr_tpu/index/device.py: the same flat int32 arrays built
from the same host ``RdBGIndex``, padded to the same power-of-two sizes
(every clip bound the seeding stages apply therefore matches the JAX
package's), with unitig/reference sequences packed 16 bases per 32-bit
word, MSB-first.
"""

from __future__ import annotations

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


def _pad_pow2(a: np.ndarray, fill, min_size: int = 256) -> np.ndarray:
    n = len(a)
    target = max(min_size, 1 << max(n - 1, 0).bit_length())
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


def to_device(idx: RdBGIndex, device="cuda") -> DeviceIndex:
    """The index tensors on `device` (default the card; a missing card
    raises, as the engine's device does; pass "cpu" for the plain path)."""
    device = resolve_device(device)
    ent_uid = np.searchsorted(idx.uni_seqf, idx.off_g, side="right") - 1
    ent_uid = np.clip(ent_uid, 0, max(idx.n_unitigs - 1, 0))
    ent_off_l = idx.off_g - idx.uni_seqf[ent_uid]
    ent_off_r = idx.uni_seqf[ent_uid + 1] - idx.off_g - idx.search_k
    ent_pos_n = idx.uni_posp[ent_uid + 1] - idx.uni_posp[ent_uid]
    n_k = len(idx.kmer_g)
    # equal-key runs of (bucket, residue); the count of a probe hit is
    # ent_run at its lower bound
    keys = (idx.kmer_g.view(np.int32) >> np.int32(
        2 * (idx.k - idx.search_k))).astype(np.int64)
    bucket_of = np.repeat(np.arange(len(idx.hash_g) - 1, dtype=np.int64),
                          np.diff(idx.hash_g).astype(np.int64))
    new_run = np.ones(n_k, bool)
    new_run[1:] = (keys[1:] != keys[:-1]) | (bucket_of[1:] != bucket_of[:-1])
    starts = np.nonzero(new_run)[0]
    run_len = np.diff(np.append(starts, n_k))
    ent_run = run_len[np.cumsum(new_run) - 1].astype(np.int32)
    off_r_c = np.minimum(ent_off_r, 2047).astype(np.int32)
    pos_n_c = np.minimum(ent_pos_n, (1 << 21) - 1).astype(np.int32)
    ent_pack = np.stack([
        _pad_pow2(idx.off_g.astype(np.int32), 0),
        _pad_pow2(ent_uid.astype(np.int32), 0),
        _pad_pow2(ent_off_l.astype(np.int32), 0),
        _pad_pow2((off_r_c | (pos_n_c << 11)).astype(np.int32), 0),
    ], axis=1)
    i32max = 0x7FFFFFFF
    ent_key = _pad_pow2((bucket_of << 32) | keys, (i32max << 32) | i32max)
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
        ent_run=t(_pad_pow2(ent_run, 0)), ent_pack=t(ent_pack),
        ent_key=t(ent_key), uni_words_pad=t(uni_words_pad))
