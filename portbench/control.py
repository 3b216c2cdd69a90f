"""The control of a cell's correctness check: the plain reference with
the configuration's two-piece gap cost broken into one affine piece
(16 + k for every gap length k where the configuration states
min(16 + k, 32)), put in the program's place and judged by the same
comparison a run makes, on the pairs a run's window would hand.

    python -m portbench.control --workload CELL --seeds 1 2 3 [--seconds S]

prints one JSON line a seed: the pairs compared, and mismatched_pairs of
the reference itself (0) and of the control. A run never runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import check, db, feed, registry


def control_readings(cell: str, seed: int, seconds: float,
                     bench_dir: str = registry.BENCH_DIR,
                     man: dict | None = None) -> dict:
    man = man or registry.manifest()
    w = registry.workload(man, cell)
    cfg, cfg_path = registry.config(w["config"], bench_dir)
    mix, _ = registry.mix(w["traffic"], bench_dir)
    db_dir = os.path.join(bench_dir, "cache", w["config"])
    if not db.is_built(db_dir, cfg):
        subprocess.run([sys.executable, "-m", "portbench.db", cfg_path,
                        db_dir], check=True, cwd=registry.ROOT)
    from .harness import pool_reads

    pool, offs, smp = feed.make_pool(db_dir, cfg, mix, seed,
                                     pool_reads(mix, seconds))
    pick = check.sample_pairs(seed, 0, int(mix["pool_reads_per_s"]
                                           * seconds / 2),
                              mix["check_pairs"])
    pairs = [check.parse_pair(feed.pair_text(pool, offs, i)) for i in pick]
    with open(os.path.join(db_dir, "header.sam")) as fh:
        names = [ln.split("\t")[1][3:] for ln in fh if ln.startswith("@SQ")]
    status = dict(read_len=smp.L, min_isize=smp.min_isize,
                  max_isize=smp.max_isize)
    idx = db.load_ref_index(os.path.join(db_dir, "refindex"))
    t = time.perf_counter()
    want = check.expected_records(idx, names, status, pairs)
    t_ref = time.perf_counter() - t
    ctl = check.expected_records(idx, names, status, pairs,
                                 check.CONTROL_PARAMS)
    return dict(cell=cell, seed=seed, pairs=len(pairs),
                records=sum(len(r) for r in want.values()),
                reference_s=t_ref,
                mismatched_pairs_reference=len(check.mismatched(want, want)),
                mismatched_pairs_control=len(check.mismatched(ctl, want)))


def main(argv: list) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float,
                   default=registry.manifest()["run_seconds"])
    a = p.parse_args(argv)
    for s in a.seeds:
        print(json.dumps(control_readings(a.workload, s, a.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
