"""The front, chain, collect and DP glue kernels (csrc/front.cu) on the
card at a batch an engine ran, held to the plain PyTorch programs bit for
bit, with each one's time, its kernels' time alone, its bytes bound and
the plain program's time on the same card (align/kernel_table.py).

    python tools/front_kernel_table.py [--json front_table.json]
    python tools/front_kernel_table.py --workload genome40k.regions \
        --seed N [--seconds 5] [--json front_table.json]

Without --workload: one batch of 8,192 simulated SV reads of 150 bp on a
200 kbp genome's anchor contigs, indexed at first level 11 (a small,
L2-resident index). With --workload: a run of that portbench cell as the
benchmark makes it (its database built first where it is missing, so
genome40k's level-14 store of 46.4M k-mers), untraced, for --seconds;
the widest front and the largest smallest-class DP chunk its engine ran
are kept and measured after the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def simulated_batch() -> None:
    """Run one card engine over 8,192 simulated SV reads."""
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import (AnchorConfig,
                                                 build_anchor_contigs)
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=41, n_sv=8, n_pairs=4096,
                      types=("DEL", "INS", "DUP"),
                      chrom_lengths={"chr1": 200_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    eng = AlignEngine(idx, ori_chrom_names=list(ds.genome), device="cuda")
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    eng.align_batch(seqs, [OriResult(unmapped=True)] * len(seqs))


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)

    import torch

    from pansvr_tpu_torch.align.kernel_table import (check_batch, keep_batch,
                                                     time_batch)

    with keep_batch() as kept:
        if a.workload is None:
            simulated_batch()
            source = "simulated: 8,192 reads, 200 kbp, first level 11"
        else:
            from portbench import harness, registry

            res = harness.run_cell(
                a.workload, registry.manifest(), a.seed, a.seconds, False,
                t0, log=lambda s: print(f"[run] {s}", file=sys.stderr))
            if not res.get("correct"):
                raise AssertionError(f"{a.workload}: the run was not "
                                     f"correct: {res}")
            source = f"{a.workload} seed {a.seed}"
    compared = check_batch(kept)
    rows = time_batch(kept, a.reps)
    report = dict(card=torch.cuda.get_device_name(0), source=source,
                  compared=compared, rows=rows)
    print(json.dumps(report, indent=1))
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
