"""The ATen op kinds fc_aln's engine build and graph warm-ups dispatch on
the card, each with the VmRSS growth across its first call, from one
untraced run of a benchmark cell.

    python tools/op_kind_growth.py --workload chrom2k.regions --seed N \
        [--seconds 10] [--json op_kinds.json]

Runs portbench's cell as the benchmark does (the database built first where
it is missing), with the engine's op-kind recorder on (AlignEngine
op_kinds, which the benchmark leaves off), keeps the engine, and prints: the build's kinds, then
the warm-ups' kinds by program kind (front, dp) in the order they first
appeared, each with its first-use growth in MiB and whether the build
had dispatched it. The sum over the warm-ups' new kinds is what they
add to the process's resident set through module loads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)

    from pansvr_tpu_torch.align import engine, programs
    from portbench import harness, registry

    orig_init = engine.AlignEngine.__init__

    def recording_init(self, *args, **kwargs):
        orig_init(self, *args, **{**kwargs, "op_kinds": True})

    engine.AlignEngine.__init__ = recording_init

    by_kind: dict[str, dict] = {}
    orig_new = programs.ProgramCache._new

    def tracked_new(self, key, fn, inputs, fixed):
        warm = getattr(self, "warmup_ops", None)
        before = set(warm.kinds) if warm is not None else set()
        prog = orig_new(self, key, fn, inputs, fixed)
        if warm is not None:
            got = by_kind.setdefault(key[0], {})
            for k, v in warm.kinds.items():
                if k not in before:
                    got[k] = v
        return prog

    programs.ProgramCache._new = tracked_new
    engines = []
    res = harness.run_cell(a.workload, registry.manifest(), a.seed,
                           a.seconds, False, t0,
                           engine_hook=engines.append,
                           log=lambda s: print(f"[run] {s}", file=sys.stderr))
    eng = engines[0]
    build = eng.build_ops.kinds
    mib = lambda v: round(1024 * v, 2)  # noqa: E731
    report = {
        "workload": a.workload, "seed": a.seed, "correct": res["correct"],
        "warmup_rss_gib": eng.prof["warmup_rss_gib"],
        "capture_rss_gib": eng.prof["capture_rss_gib"],
        "n_graph_capture": eng.prof["n_graph_capture"],
        "n_warmup_new_op_kinds": eng.prof["n_warmup_new_op_kinds"],
        "build": {k: mib(v) for k, v in build.items()},
        "warmup": {kind: [(k, mib(v), k in build) for k, v in got.items()]
                   for kind, got in by_kind.items()},
    }
    print(f"build: {len(build)} kinds, "
          f"{sum(report['build'].values()):.1f} MiB over their first calls")
    for k, v in sorted(report["build"].items(), key=lambda x: -x[1]):
        print(f"  build {k} {v}")
    for kind, rows in report["warmup"].items():
        new = [r for r in rows if not r[2]]
        print(f"warm-ups of {kind}: {len(rows)} kinds first met, {len(new)} "
              f"new to the build, {sum(r[1] for r in new):.1f} MiB over "
              f"the new ones' first calls")
        for name, g, known in sorted(rows, key=lambda r: -r[1]):
            print(f"  {kind} {name} {g}{'' if not known else ' (build)'}")
    print(f"warmup_rss_gib {report['warmup_rss_gib']:.4f}, "
          f"n_warmup_new_op_kinds {report['n_warmup_new_op_kinds']:.0f}, "
          f"captures {report['n_graph_capture']:.0f}, correct "
          f"{res['correct']}")
    if a.json:
        os.makedirs(os.path.dirname(a.json) or ".", exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
