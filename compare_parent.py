#!/usr/bin/env python3
"""This tree against another checkout of the repo (an earlier commit) on
the card: the forward kernel (K1) alone, the traceback kernel (K2) alone,
and the fc_aln entry point.

    git archive <commit> | tar -x -C smoke_src/parent   # a gitignored dir
    python3 compare_parent.py smoke_src/parent [--other-abi 16|17]
        [--reps N] [--passes N] [--json PATH] [--no-fc-aln]

K1, in this process: builds OTHER/pansvr_tpu_torch/csrc with nvcc beside
this tree's kernels and makes chip_smoke.py's seeded DP problems for every
class of its DP_SETS. Per class it checks that the other kernel, this one
and this one's int32 instance give identical outputs (the nine fields and
every direction byte), then times each alone (CUDA events around --reps
raw launches after a warm-up) in the order other, this, this int32, and
the same backwards; a kernel's time is the mean of its two. The int32
instance is timed only where the class takes the packed 16-bit state, to
show what that state buys. --other-abi is the number of int arguments of
the other library's pansvr_extd2_fwd: 16 for the int32-state kernel before
the state16 flag, 17 for the kernel with it.

K2, in this process: the other library's pansvr_extd2_tb (the same ABI
since the port began: 7 pointers, 5 ints, the stream).
Per class, on this tree's K1 direction bytes and chip_smoke's traceback
starts, at the set's size and at each problem count the engine launches
for the class (chip_smoke.main_sizes): ops and final (i, j) of the other
kernel and this one byte-identical, then each timed alone in the order
other, this, this, other (--reps raw launches each); a kernel's time is
the mean of its two.

fc_aln: builds chip_smoke.py's bench world once and starts one process
per tree that runs the tree's fc_aln CLI entry point (default engine
configuration, -b 8192, --device cuda, an index copy of its own). Each
makes a warm-up pass; then --passes timed passes of each are taken in
turns (other, this, this, other, ...), one process idle while the other
runs, so both see the same drift of the shared host. Prints every pass
with its engine phase timers and each tree's median reads/s, and fails
unless both trees write identical BAM records.

--json PATH writes all of it, with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# one fc_aln process per tree (run with the cwd and PYTHONPATH of the tree
# under test, so it imports that tree's package): a warm-up pass, then one
# timed pass per line on its stdin
_FC_ALN_DRIVER = r"""
import json, sys, time
from pansvr_tpu_torch.cli.main import parse_args, run_fc_aln
argv, out = json.loads(sys.argv[1])
run_fc_aln(parse_args(argv + ["-o", out + ".warm.bam"]))
print("READY", flush=True)
for _ in sys.stdin:
    t = time.perf_counter()
    eng = run_fc_aln(parse_args(argv + ["-o", out]))
    wall = time.perf_counter() - t
    prof = {k: round(float(v), 4) for k, v in sorted(eng.prof.items())}
    print("PASS " + json.dumps(dict(wall=wall, prof=prof)), flush=True)
"""


def fwd_launcher(lib, n_int, qc, ql, tc, tl, out, dmat, params, W, state16):
    """Raw launch of a library's pansvr_extd2_fwd taking n_int ints (17:
    the last one is the packed-state flag)."""
    import torch

    from pansvr_tpu_torch.ops.extd2 import plan

    B, Qmax = qc.shape
    Tmax = tc.shape[1]
    t_pad, n_diag_pad, _, _ = plan(Qmax, Tmax, W)
    pn = params.normalized()
    ints = [B, Qmax, Tmax, W, t_pad, n_diag_pad, params.match,
            params.mismatch, pn.q, pn.e, pn.q2, pn.e2, params.w, params.zdrop,
            params.long_thres, params.long_diff] + [int(state16)] * (n_int - 16)
    args = (qc.data_ptr(), ql.data_ptr(), tc.data_ptr(), tl.data_ptr(),
            out.data_ptr(), dmat.data_ptr(), *ints,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.pansvr_extd2_fwd(*args)
        if err:
            raise RuntimeError(f"extd2_fwd launch: CUDA error {err}")
    return launch


def bind(path, n_int):
    """A kernel library with pansvr_extd2_fwd taking n_int ints (and
    pansvr_extd2_tb: 7 pointers, 5 ints, the stream)."""
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pansvr_extd2_fwd.restype = I
    lib.pansvr_extd2_fwd.argtypes = [P] * 6 + [I] * n_int + [P]
    lib.pansvr_extd2_tb.restype = I
    lib.pansvr_extd2_tb.argtypes = [P] * 7 + [I] * 5 + [P]
    return lib


def dp_sets(dev):
    """chip_smoke's seeded problems of every DP class, in its order:
    (Q, T, W, params, n_diag_pad, qc, ql, tc, tl) on the card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pansvr_tpu_torch.ops.extd2 import Extd2Params, plan

    rng = np.random.default_rng(2024)
    for Q, T, W, prof, n_prob, _ in cs.DP_SETS:
        pairs = cs.make_problems(rng, Q, T, n_prob)
        B = len(pairs)
        qc = np.zeros((B, Q), np.uint8)
        tc = np.zeros((B, T), np.uint8)
        ql = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i, (q, t) in enumerate(pairs):
            qc[i, : len(q)], tc[i, : len(t)] = q, t
            ql[i], tl[i] = len(q), len(t)
        qc, ql, tc, tl = (torch.from_numpy(a).to(dev) for a in (qc, ql, tc, tl))
        yield Q, T, W, Extd2Params(**prof), plan(Q, T, W)[1], qc, ql, tc, tl


def other_library(other_root):
    """The other tree's kernels, built from its csrc/ beside this tree's."""
    from pansvr_tpu_torch import _build

    other_so = os.path.join(REPO, "build", "kernels", "libother_kernels.so")
    _build.compile_library(
        os.path.join(other_root, "pansvr_tpu_torch", "csrc"), other_so)
    return other_so


def k1_rows(other_so, other_abi, reps):
    import torch

    import chip_smoke as cs
    from pansvr_tpu_torch import _build
    from pansvr_tpu_torch.ops import extd2_cuda as ec

    _build.load_kernels()
    this = bind(_build.library_path(), 17)
    other = bind(other_so, other_abi)

    dev = torch.device("cuda")
    rows = []
    for Q, T, W, params, n_diag_pad, qc, ql, tc, tl in dp_sets(dev):
        B = qc.shape[0]
        state16 = ec.packed_state(params, W)
        variants = [("other", other, other_abi, state16),
                    ("this", this, 17, state16)]
        if state16:
            variants.append(("this_int32", this, 17, False))
        runs, outs = [], []
        for _, lib, n_int, s16 in variants:
            # kernels before the state16 flag left unreached dmat rows to
            # the caller, so every dmat starts zeroed
            out = torch.empty((9, B), dtype=torch.int32, device=dev)
            dmat = torch.zeros((B, n_diag_pad, W), dtype=torch.uint8,
                               device=dev)
            runs.append(fwd_launcher(lib, n_int, qc, ql, tc, tl, out, dmat,
                                     params, W, s16))
            runs[-1]()
            outs.append((out, dmat))
        torch.cuda.synchronize()
        for (name, *_), (out, dmat) in zip(variants[1:], outs[1:]):
            if not (torch.equal(out, outs[0][0])
                    and torch.equal(dmat, outs[0][1])):
                bad = ((out != outs[0][0]).any(0)
                       | (dmat != outs[0][1]).flatten(1).any(1)).nonzero()
                raise AssertionError(
                    f"K1 {Q}x{T}/W{W}: {name} differs from the other tree's "
                    f"kernel in {bad.numel()} of {B} problems (first "
                    f"{bad.flatten()[:5].tolist()})")
        t = [cs.cuda_ms(f, reps) for f in runs + runs[::-1]]
        ms = {name: (t[i] + t[-1 - i]) / 2
              for i, (name, *_) in enumerate(variants)}
        row = dict(shape=[Q, T, W], n=B, state16=state16, times_ms=t,
                   **{f"{k}_ms": v for k, v in ms.items()},
                   speedup=ms["other"] / ms["this"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def k2_rows(other_so, reps):
    """K2 of the other tree against this tree's, per class and size."""
    import torch

    import chip_smoke as cs
    from pansvr_tpu_torch.ops import extd2_cuda as ec

    other = bind(other_so, 17)
    dev = torch.device("cuda")
    rows = []
    for Q, T, W, params, n_diag_pad, qc, ql, tc, tl in dp_sets(dev):
        got = ec.extd2_fwd(qc, ql, tc, tl, params, W)
        zd = got.zdropped
        i0 = torch.where(~zd, tl - 1, torch.where(got.max_t >= 0, got.max_t,
                                                  -1)).to(torch.int32)
        j0 = torch.where(~zd, ql - 1, torch.where(got.max_q >= 0, got.max_q,
                                                  -1)).to(torch.int32)
        t_pad = max((T + 15) // 16 * 16, W)
        B = qc.shape[0]
        for n in sorted({B, *cs.main_sizes(Q, T)}, reverse=True):
            sl = slice(0, n)
            args = (got.dmat[sl], ql[sl], tl[sl], i0[sl], j0[sl], params, W,
                    n_diag_pad, T)
            ops_o = torch.empty((n, n_diag_pad), dtype=torch.int8, device=dev)
            fin_o = torch.empty((2, n), dtype=torch.int32, device=dev)
            o_args = (*(a.contiguous().data_ptr() for a in args[:5]),
                      ops_o.data_ptr(), fin_o.data_ptr(), n, W, n_diag_pad,
                      t_pad, params.w, torch.cuda.current_stream().cuda_stream)

            def run_other():
                err = other.pansvr_extd2_tb(*o_args)
                if err:
                    raise RuntimeError(f"other extd2_tb launch: CUDA error {err}")

            run_other()
            ops, i_f, j_f = ec.extd2_traceback(*args)
            torch.cuda.synchronize()
            if not (torch.equal(ops, ops_o) and torch.equal(i_f, fin_o[0])
                    and torch.equal(j_f, fin_o[1])):
                bad = ((ops != ops_o).any(1) | (i_f != fin_o[0])
                       | (j_f != fin_o[1])).nonzero().flatten()
                raise AssertionError(
                    f"K2 {Q}x{T}/W{W} at {n}: this kernel differs from the "
                    f"other tree's in {bad.numel()} problems (first "
                    f"{bad[:5].tolist()})")
            this = ec.tb_raw_launcher(*args)
            t = [cs.cuda_ms(f, reps) for f in (run_other, this, this, run_other)]
            walks = (ops != 3).sum(1)
            row = dict(shape=[Q, T, W], n=n, steps=int(walks.sum().item()),
                       longest=int(walks.max().item()), times_ms=t,
                       other_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2)
            row["speedup"] = row["other_ms"] / row["this_ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _expect(proc, tag, name):
    """The payload of the next line of a driver process that starts with
    tag; raises if the process ends first."""
    for line in proc.stdout:
        if line.startswith(tag):
            return line[len(tag):].strip()
    proc.wait()
    raise RuntimeError(f"fc_aln driver of {name} exited {proc.returncode} "
                       f"before {tag.strip()!r} (its stderr is in the log)")


def fc_aln_rows(other_root, passes):
    import shutil
    import statistics

    import chip_smoke as cs
    from pansvr_tpu_torch import world

    trees = {"other": other_root, "this": REPO}
    res = {k: dict(walls=[], profs=[]) for k in trees}
    procs = {}
    with tempfile.TemporaryDirectory(prefix="pansvr_compare_") as tmp:
        w = world.build_bench_world(os.path.join(tmp, "world"))
        n_reads = sum(1 for _ in open(w["signal"])) // 4
        n_pr = n_reads // 2 * 2
        try:
            for name, root in trees.items():
                # an index copy each, so each keeps its own engine_tune.json
                index = os.path.join(tmp, f"index_{name}")
                shutil.copytree(w["index"], index)
                argv = ["fc_aln", index, w["signal"], w["header"], "-r",
                        w["status"], "-b", str(cs.BATCH), "--device", "cuda"]
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", _FC_ALN_DRIVER,
                     json.dumps([argv, os.path.join(tmp, f"{name}.bam")])],
                    cwd=root, env=dict(os.environ, PYTHONPATH=root),
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=open(os.path.join(tmp, f"{name}.err"), "w"),
                    text=True)
                _expect(procs[name], "READY", name)
            for i in range(passes):
                for name in (("other", "this"), ("this", "other"))[i % 2]:
                    procs[name].stdin.write("pass\n")
                    procs[name].stdin.flush()
                    got = json.loads(_expect(procs[name], "PASS ", name))
                    res[name]["walls"].append(got["wall"])
                    res[name]["profs"].append(got["prof"])
                    print(f"fc_aln {name}: {got['wall']:.3f} s = "
                          f"{n_pr / got['wall']:.1f} reads/s; {got['prof']}",
                          flush=True)
            for name, p in procs.items():
                p.stdin.close()
                if p.wait(timeout=120):
                    raise RuntimeError(f"fc_aln driver of {name} exited "
                                       f"{p.returncode}")
        finally:
            for name, p in procs.items():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                with open(os.path.join(tmp, f"{name}.err")) as fh:
                    err = fh.read()
                if p.returncode:
                    print(f"stderr of the {name} driver:\n{err[-4000:]}",
                          file=sys.stderr, flush=True)
        n_rec = cs.same_bam(os.path.join(tmp, "other.bam"),
                            os.path.join(tmp, "this.bam"),
                            "fc_aln other tree vs this tree")
    for name, r in res.items():
        r["median_reads_per_s"] = n_pr / statistics.median(r["walls"])
        print(f"fc_aln {name}: median {r['median_reads_per_s']:.1f} reads/s "
              f"over {len(r['walls'])} passes", flush=True)
    print(f"fc_aln: {n_rec} BAM records identical between the trees",
          flush=True)
    return dict(reads=n_pr, bam_records=n_rec, **res)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--other-abi", type=int, choices=(16, 17), default=17)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--passes", type=int, default=6)
    ap.add_argument("--json", help="write the results to this file too")
    ap.add_argument("--no-fc-aln", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    other_root = os.path.abspath(args.other)
    card = cs.card_line()
    print(card, flush=True)
    other_so = other_library(other_root)
    result = dict(card=card, other=args.other, other_abi=args.other_abi,
                  reps=args.reps,
                  k1=k1_rows(other_so, args.other_abi, args.reps),
                  k2=k2_rows(other_so, args.reps))
    if not args.no_fc_aln:
        result["fc_aln"] = fc_aln_rows(other_root, args.passes)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
