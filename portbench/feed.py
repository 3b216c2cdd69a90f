"""The sample's signal FASTQ, from a process of its own.

    python -m portbench.feed DB_DIR CONFIG_JSON MIX_JSON SEED N_READS FD

generates the sample's first N_READS signal reads (gen.Sampler), says
so on standard output as one JSON line (pairs, status text), then
writes the FASTQ to file descriptor FD (a pipe the harness reads with
the program's own FASTQ reader) until the reader closes it: first the
warm-up, the mix's warmup_batches batches each cut from another part
of the pool, evenly spread over it (named p<k>_<i>w0), so that the
program meets the shape sets of the whole sample before the window;
then the pool from its start, and past its end again with fresh read
names (pair i of chunk k is p<k>_<i>c<cycle>).
Then it answers requests on standard input, one JSON line each:
{"pairs": [stream pair index, ...]} gets the FASTQ text of those pairs;
end of input ends the process. The pool lives in this process, so the
measured process holds no input beyond what its reader buffers.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from . import db as dbmod
from . import gen

WRITE = 1 << 20
# processes that make the pool's chunks: the CPUs the feeder may use, up
# to 8 (the measured process waits while they run)
WORKERS = max(1, min(8, len(os.sched_getaffinity(0))
                     if hasattr(os, "sched_getaffinity") else
                     os.cpu_count() or 1))


_SAMPLER = {}


def _chunk(db_dir: str, cfg: dict, mix: dict, seed: int, k: int):
    """FASTQ text and pair offsets of chunk k (in a worker process)."""
    key = (db_dir, seed)
    if key not in _SAMPLER:
        _SAMPLER.clear()
        _SAMPLER[key] = gen.Sampler(dbmod.load(db_dir), cfg, mix, seed)
    smp = _SAMPLER[key]
    return smp.fastq(smp.chunk(k), k)


def make_pool(db_dir: str, cfg: dict, mix: dict, seed: int, n_reads: int,
              workers: int = 4):
    """(FASTQ bytes of whole pairs, pair offsets, Sampler) of the sample's
    first n_reads reads (at least one chunk; at most the whole sample),
    its chunks made by `workers` processes and joined in order. Once a
    chunk is back, no more chunks are started than the pairs still
    needed take at the mean size so far, so that no worker runs on a
    chunk the pool will not hold."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    smp = gen.Sampler(dbmod.load(db_dir), cfg, mix, seed)
    blocks, offs, n, size = [], [np.zeros(1, np.int64)], 0, 0
    need = (n_reads + 1) // 2
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        futs, k = [], 0
        while 2 * n < n_reads and (futs or k < len(smp.chunks)):
            per = n / len(blocks) if blocks else 0
            while (k < len(smp.chunks) and len(futs) < workers
                   and (not per or n + len(futs) * per < need)):
                futs.append(ex.submit(_chunk, db_dir, cfg, mix, seed, k))
                k += 1
            text, o = futs.pop(0).result()
            blocks.append(text)
            offs.append(o[1:] + size)
            size += len(text)
            n += len(o) - 1
        for f in futs:
            f.cancel()
    return b"".join(blocks), np.concatenate(offs), smp


def warmup_pieces(offs, n_batches: int, batch_reads: int) -> list:
    """(first, last) byte of each warm-up batch in the pool: batch j is
    the batch_reads // 2 pairs from pair j * n_pairs // n_batches on,
    wrapping round the pool's end."""
    n, per = len(offs) - 1, batch_reads // 2
    out = []
    for j in range(n_batches):
        a = j * n // n_batches
        b = a + per
        out += [(offs[a], offs[min(b, n)])] + (
            [(offs[0], offs[b - n])] if b > n else [])
    return out


def pair_text(pool: bytes, offs, i: int) -> str:
    n = len(offs) - 1
    text = pool[offs[i % n] : offs[i % n + 1]].decode()
    return text if i < n else text.replace("c0 ", f"c{i // n} ")


def main(argv: list) -> int:
    db_dir, cfg_path, mix_path, seed, n_reads, fd = argv
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    with open(mix_path) as fh:
        mix = json.load(fh)
    pool, offs, smp = make_pool(db_dir, cfg, mix, int(seed), int(n_reads),
                                WORKERS)
    n_pairs = len(offs) - 1
    sys.stdout.write(json.dumps(dict(pairs=n_pairs, bytes=len(pool),
                                     status=smp.status_text())) + "\n")
    sys.stdout.flush()
    fd = int(fd)
    try:
        import fcntl

        fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, WRITE)
    except (ImportError, AttributeError, OSError):
        pass
    # pieces of about WRITE bytes that end at a pair's end, so that a
    # cycle's renaming happens piece by piece as the reader takes them
    cuts = np.unique(np.concatenate([
        offs[np.searchsorted(offs, np.arange(0, len(pool), WRITE))],
        [len(pool)]]))

    def send(data: bytes) -> None:
        view, o = memoryview(data), 0
        while o < len(view):
            o += os.write(fd, view[o:])

    cycle = 0
    try:
        for lo, hi in warmup_pieces(offs, mix["warmup_batches"],
                                    mix["batch_reads"]):
            send(pool[lo:hi].replace(b"c0 ", b"w0 "))
        while True:
            tag = f"c{cycle} ".encode()
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                piece = pool[lo:hi]
                send(piece if cycle == 0 else piece.replace(b"c0 ", tag))
            cycle += 1
    except BrokenPipeError:
        pass
    finally:
        os.close(fd)
    for line in sys.stdin:
        req = json.loads(line)
        out = [pair_text(pool, offs, int(i)) for i in req["pairs"]]
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
