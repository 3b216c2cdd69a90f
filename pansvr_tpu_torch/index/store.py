"""On-disk RdBG index: a directory of flat binary arrays, memory-mapped
at load.

TPU-native analog of the reference's 9-file deBGA index directory
(deBGA_index.cpp:33-80 loads ref.seq / unipath.* / unipath_g.* as flat
buffers): each RdBGIndex array is one .npy file, loaded with
``np.load(mmap_mode="r")`` so a whole-genome index costs page-cache, not
process RSS — the fix for the monolithic-pickle load that peaked at
2+ GB for a megabase anchor set (the 4^14 first-level table alone is
1.07 GB; see builder.resolve_first_level for the other half of that
fix). Contig names (the anchor metadata channel) go to ``chr_names.txt``
one per line, like the reference's unipath.chr.

``save_index`` + ``load_index`` round-trip exactly (tested); loaded
arrays are read-only memmaps with the same dtypes/shapes the builder
produces.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .builder import RdBGIndex

MANIFEST = "manifest.json"
FORMAT_VERSION = 1

_ARRAYS = (
    "ref_codes", "ref_words", "chr_starts",
    "uni_codes", "uni_words", "uni_seqf", "uni_pos", "uni_posp",
    "hash_g", "kmer_g", "off_g",
)


def save_index(idx: RdBGIndex, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in _ARRAYS:
        np.save(os.path.join(out_dir, f"{name}.npy"),
                np.ascontiguousarray(getattr(idx, name)))
    with open(os.path.join(out_dir, "chr_names.txt"), "w") as fh:
        for n in idx.chr_names:
            fh.write(n + "\n")
    with open(os.path.join(out_dir, MANIFEST), "w") as fh:
        json.dump({
            "format_version": FORMAT_VERSION,
            "k": idx.k,
            "search_k": idx.search_k,
            "first_level_bases": idx.first_level_bases,
            "n_contigs": len(idx.chr_names),
        }, fh, indent=1)
        fh.write("\n")


def is_index_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))


def load_index(index_dir: str, mmap: bool = True) -> RdBGIndex:
    with open(os.path.join(index_dir, MANIFEST)) as fh:
        meta = json.load(fh)
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"index format v{meta['format_version']} is newer than this "
            f"reader (v{FORMAT_VERSION})")
    mode = "r" if mmap else None
    arrays = {
        name: np.load(os.path.join(index_dir, f"{name}.npy"),
                      mmap_mode=mode)
        for name in _ARRAYS
    }
    with open(os.path.join(index_dir, "chr_names.txt")) as fh:
        chr_names = [ln.rstrip("\n") for ln in fh]
    assert len(chr_names) == meta["n_contigs"]
    return RdBGIndex(
        k=meta["k"], search_k=meta["search_k"],
        first_level_bases=meta["first_level_bases"],
        chr_names=chr_names, **arrays,
    )


def load_any(path: str, mmap: bool = True) -> RdBGIndex:
    """Load an index from a store directory, a legacy rdbg.pkl (inside a
    directory or given directly), or a deBGA index directory."""
    if os.path.isdir(path):
        if is_index_dir(path):
            return load_index(path, mmap=mmap)
        sub = os.path.join(path, "rdbg")
        if is_index_dir(sub):
            return load_index(sub, mmap=mmap)
        pkl = os.path.join(path, "rdbg.pkl")
        if os.path.isfile(pkl):
            import pickle

            with open(pkl, "rb") as fh:
                return pickle.load(fh)
        if os.path.isfile(os.path.join(path, "unipath_g.hash")):
            from .debga_io import load_debga_index

            return load_debga_index(path)
        raise FileNotFoundError(f"no index found under {path}")
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as fh:
            return pickle.load(fh)
    raise FileNotFoundError(path)
