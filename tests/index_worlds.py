"""Synthetic RdBG indexes for the device-index tests (the port's own
builder types only: no jax, so the card tests import it too)."""

import numpy as np


def synthetic_index(n_k, level=12, n_uni=20_000, seed=11):
    """An RdBGIndex of n_k random entries whose first-level buckets lie
    in [5000, 4^level - 7000): runs of empty buckets at both ends of the
    table and between the entries."""
    from pansvr_tpu_torch.index.builder import K_T, LEN_KMER, RdBGIndex

    rng = np.random.default_rng(seed)
    low = np.uint64(2 * (K_T - level))
    bucket = rng.integers(5000, 4 ** level - 7000, n_k).astype(np.uint64)
    full = np.sort((bucket << low) | rng.integers(
        0, 1 << int(low), n_k).astype(np.uint64))
    hash_g = np.searchsorted(full, np.arange(4 ** level + 1, dtype=np.uint64)
                             << low).astype(np.int32)
    uni_len = n_k + n_uni * K_T
    cuts = np.sort(rng.choice(uni_len - 1, n_uni - 1, replace=False) + 1)
    posp = np.concatenate([[0], np.cumsum(rng.integers(1, 4, n_uni))])
    return RdBGIndex(
        k=K_T, search_k=LEN_KMER, first_level_bases=level,
        ref_codes=rng.integers(0, 5, 4000).astype(np.uint8),
        ref_words=np.zeros(250, np.uint64), chr_names=["c"],
        chr_starts=np.array([0, 4000]),
        uni_codes=rng.integers(0, 5, uni_len).astype(np.uint8),
        uni_words=np.zeros(1, np.uint64),
        uni_seqf=np.concatenate([[0], cuts, [uni_len]]).astype(np.int64),
        uni_pos=rng.integers(0, 4000, posp[-1]), uni_posp=posp,
        hash_g=hash_g, kmer_g=(full & ((np.uint64(1) << low) - np.uint64(1))
                               ).astype(np.uint32),
        off_g=rng.integers(0, uni_len - K_T, n_k))
