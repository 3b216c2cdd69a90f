"""A configuration's SV database, built once per checkout.

    python -m portbench.db CONFIG_JSON OUT_DIR

writes into OUT_DIR the database that users index once and realign every
sample against: genome.npy (the genome's base codes), svs.npz (the SVs),
anchors.fa (fc_anchor_ref's contigs), header.sam (the sample BAM's
header), rdbg/ (the program's index store, by its own `fc_index`
command) and refindex/ (the plain reference's index, by its frozen copy
of the builder), then done.json. The two indexes build in parallel, each
in a process of its own. The harness runs this in a child process, so
that none of it counts in the measured process's memory.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

from . import gen

REF_ARRAYS = ("ref_codes", "ref_words", "chr_starts", "uni_codes",
              "uni_words", "uni_seqf", "uni_pos", "uni_posp", "hash_g",
              "kmer_g", "off_g")


def stamp(cfg: dict) -> str:
    return json.dumps(cfg["database"], sort_keys=True)


def is_built(out_dir: str, cfg: dict) -> bool:
    try:
        with open(os.path.join(out_dir, "done.json")) as fh:
            return json.load(fh).get("database") == stamp(cfg)
    except (OSError, ValueError):
        return False


def load(out_dir: str) -> gen.Database:
    """The database's genome (memory-mapped) and SVs."""
    with open(os.path.join(out_dir, "done.json")) as fh:
        meta = json.load(fh)
    sv = np.load(os.path.join(out_dir, "svs.npz"))
    lengths = np.array(meta["lengths"], np.int64)
    return gen.Database(
        meta["names"], lengths,
        np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64),
        np.load(os.path.join(out_dir, "genome.npy"), mmap_mode="r"),
        sv["chrom"], sv["pos1"], sv["type"], sv["len"], sv["src"])


def write_fasta(path: str, records, width: int = 70) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


def read_fasta(path: str) -> list:
    out, name, parts = [], None, []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line)
    if name is not None:
        out.append((name, "".join(parts)))
    return out


def build_ref_index(anchors_fa: str, out_dir: str) -> None:
    """The plain reference's own index of the anchors (frozen builder)."""
    from .reference.index_builder import build_index

    idx = build_index(read_fasta(anchors_fa))
    os.makedirs(out_dir, exist_ok=True)
    for name in REF_ARRAYS:
        np.save(os.path.join(out_dir, f"{name}.npy"),
                np.ascontiguousarray(getattr(idx, name)))
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(dict(k=idx.k, search_k=idx.search_k,
                       first_level_bases=idx.first_level_bases,
                       chr_names=list(idx.chr_names)), fh)


def load_ref_index(out_dir: str):
    from .reference.index_builder import RdBGIndex

    with open(os.path.join(out_dir, "meta.json")) as fh:
        meta = json.load(fh)
    arrays = {n: np.load(os.path.join(out_dir, f"{n}.npy"), mmap_mode="r")
              for n in REF_ARRAYS}
    return RdBGIndex(k=meta["k"], search_k=meta["search_k"],
                     first_level_bases=meta["first_level_bases"],
                     chr_names=meta["chr_names"], **arrays)


def build(cfg: dict, out_dir: str) -> None:
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    db = gen.make_database(cfg)
    np.save(os.path.join(out_dir, "genome.npy"), db.genome)
    np.savez(os.path.join(out_dir, "svs.npz"), chrom=db.sv_chrom,
             pos1=db.sv_pos1, type=db.sv_type, len=db.sv_len, src=db.sv_src)
    anchors = os.path.join(out_dir, "anchors.fa")
    write_fasta(anchors, gen.anchor_records(db))
    with open(os.path.join(out_dir, "header.sam"), "w") as fh:
        fh.write(gen.header_text(db))
    del db
    fl = str(cfg["database"]["first_level"])
    env = dict(os.environ, USE_FLAX="0", USE_TF="0")
    procs = [
        subprocess.Popen([sys.executable, "-m", "pansvr_tpu_torch",
                          "fc_index", anchors, os.path.join(out_dir, "rdbg"),
                          "--first-level", fl], env=env),
        subprocess.Popen([sys.executable, "-m", "portbench.db", "--refindex",
                          anchors, os.path.join(out_dir, "refindex")],
                         env=env),
    ]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"index builds failed: exit codes {rcs}")
    d = cfg["database"]
    with open(os.path.join(out_dir, "done.json"), "w") as fh:
        json.dump(dict(database=stamp(cfg), names=list(d["chrom_lengths"]),
                       lengths=list(d["chrom_lengths"].values())), fh)


def main(argv: list) -> int:
    if argv[0] == "--refindex":
        build_ref_index(argv[1], argv[2])
        return 0
    with open(argv[0]) as fh:
        cfg = json.load(fh)
    build(cfg, argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
