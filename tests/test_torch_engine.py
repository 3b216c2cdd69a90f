"""The port's fc_aln engine and CLI on the CPU (plain kernel versions) vs
the JAX package and the NumPy host aligner: identical alignments and
identical BAM records, with the adaptive layer (retier, device collect
and its budget growth, engine_tune.json) taking the JAX engine's
decisions. Also: the port imports no JAX, and asks for a card only where
one is requested."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pansvr_tpu.align.engine import AlignEngine as JaxEngine
from pansvr_tpu.align.engine import EngineConfig as JaxConfig
from pansvr_tpu.align.host_align import HostAligner, OriResult
from pansvr_tpu.anchor.builder import AnchorConfig, build_anchor_contigs
from pansvr_tpu.index.builder import build_index
from pansvr_tpu.index.store import save_index
from pansvr_tpu.io.bam import BamReader
from pansvr_tpu.utils import dna
from pansvr_tpu.utils.simulate import DictGenome, make_dataset
from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world():
    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    names = list(ds.genome)
    return (ds, idx, HostAligner(idx, ori_chrom_names=names),
            AlignEngine(idx, ori_chrom_names=names, device="cpu"))


def _mutated(idx, rng, n, L):
    seqs = []
    for _ in range(n):
        cid = int(rng.integers(len(idx.chr_names)))
        s = idx.contig_seq_codes(cid)
        p = int(rng.integers(0, max(1, len(s) - L - 10)))
        codes = list(s[p : p + L])
        for _ in range(int(rng.integers(0, 3))):
            g = int(rng.integers(-12, 13))
            pos = int(rng.integers(10, len(codes) - 14))
            if g > 0:
                codes[pos:pos] = [int(rng.integers(0, 4))] * g
            elif g < 0:
                del codes[pos : pos - g]
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, len(codes)))
            codes[pos] = (codes[pos] + 1) % 4
        codes = np.where(np.array(codes[:L]) >= 4, 0, codes[:L])
        seqs.append(dna.decode(codes.astype(np.uint8)))
    return seqs


def _state(eng):
    """The adaptive state both engines must agree on after every batch."""
    c = eng.cfg
    return (eng._k_spec, eng._comp_cap, c.mem_slots, c.max_seeds,
            c.chain_bucket, c.nf_mult, c.collect_mult)


def _cmp(sh, se, tag):
    assert len(sh.results) == len(se.results), f"{tag}: result count"
    for k, (a, b) in enumerate(zip(sh.results, se.results)):
        for f in ("align_score", "chain_score", "direction", "ref_bg",
                  "sv_id", "mapq", "cigar"):
            assert getattr(a, f) == getattr(b, f), f"{tag} result {k} {f}"


@pytest.fixture(scope="module")
def parallel_world():
    """tests/test_parallel.py's engine world, laid out as `world`."""
    ds = make_dataset(seed=44, n_sv=4, n_pairs=80, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 120_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    names = list(ds.genome)
    return (ds, idx, HostAligner(idx, ori_chrom_names=names),
            AlignEngine(idx, ori_chrom_names=names, device="cpu"))


@pytest.mark.parametrize("reads", ["sim", "mutated", "len250", "parallel"])
def test_engine_matches_host_and_jax(request, reads):
    """One batch through the port's engine equals the host aligner's and
    the JAX engine's alignments; "parallel" is tests/test_parallel.py's
    engine world with its 48 pairs, which the JAX package also runs
    sharded over a mesh."""
    ds, idx, host, eng = request.getfixturevalue(
        "parallel_world" if reads == "parallel" else "world")
    if reads == "parallel":
        rs = ds.reads[:48]
        seqs = [r.seq1 for r in rs] + [r.seq2 for r in rs]
    elif reads == "sim":
        rs = ds.reads[:60]
        seqs = [r.seq1 for r in rs] + [r.seq2 for r in rs]
    elif reads == "mutated":
        seqs = _mutated(idx, np.random.default_rng(41), 24, 160)
    else:       # 256 read class: DP class (272, 352)
        seqs = _mutated(idx, np.random.default_rng(42), 16, 250)
    oris = [OriResult(unmapped=True)] * len(seqs)
    got = eng.align_batch(seqs, oris)
    jeng = JaxEngine(idx, ori_chrom_names=list(ds.genome),
                     config=JaxConfig(collect="host"))
    jgot = jeng.align_batch(seqs, oris)
    n_with = 0
    for i, seq in enumerate(seqs):
        expect = host.align_read(seq, oris[i])
        _cmp(expect, got[i], f"{reads}{i} host")
        _cmp(jgot[i], got[i], f"{reads}{i} jax")
        n_with += bool(expect.results)
    assert n_with >= len(seqs) // 3
    assert eng.prof["n_dp_req"] > 0


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    from pansvr_tpu.signal.extract import SignalOptions, extract_signal
    from pansvr_tpu.utils.simulate import write_sim_bam

    d = tmp_path_factory.mktemp("torch_cli")
    ds = make_dataset(seed=21, n_sv=8, n_pairs=300, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs],
                      first_level_bases="auto")
    save_index(idx, str(d / "rdbg"))
    write_sim_bam(ds, str(d / "sim.bam"))
    with open(d / "signal.fq", "w") as fh:
        stats = extract_signal(
            str(d / "sim.bam"), fh,
            opts=SignalOptions(discard_both_full_match=True,
                               not_using_filter=True))
    with open(d / "status.sam", "w") as fh:
        fh.write(stats.status_file_text())
    with open(d / "header.sam", "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c, s in ds.genome.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{len(s)}\n")
    return d


def _records(path):
    return [(r.name, r.flag, r.tid, r.pos, r.mapq, tuple(r.cigar),
             tuple(map(tuple, r.tags))) for r in BamReader(path)]


# runs the port's CLI with jax and the JAX package blocked, so an import
# of either anywhere on its path fails the run
_NO_JAX_MAIN = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['pansvr_tpu'] = None; "
                "runpy.run_module('pansvr_tpu_torch', run_name='__main__')")


@pytest.mark.parametrize("side_channel", [False, True],
                         ids=["native_emit", "ori_side_channel"])
def test_fc_aln_cli_matches_jax_cli(cli_world, side_channel):
    """Both CLIs give the same BAM records. The port's CLI runs twice on
    one index directory: the first run starts without engine_tune.json
    and writes it, the second loads it and gives the same records."""
    d = cli_world
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tune = d / "rdbg" / "engine_tune.json"
    outs = {}
    for run, (pkg, launch, extra) in enumerate((
            ("pansvr_tpu", ["-m", "pansvr_tpu"], []),
            ("pansvr_tpu_torch", ["-c", _NO_JAX_MAIN], ["--device", "cpu"]),
            ("pansvr_tpu_torch", ["-c", _NO_JAX_MAIN], ["--device", "cpu"]))):
        out = d / f"{run}_{side_channel}.bam"
        ori = d / f"{run}_{side_channel}_ori.bam"
        args = ["fc_aln", "-o", str(out), "-b", "128",
                "-r", str(d / "status.sam"), *extra, str(d / "rdbg"),
                str(d / "signal.fq"), str(d / "header.sam")]
        if side_channel:
            args[1:1] = ["-p", str(ori)]
        if run == 1 and tune.exists():
            tune.unlink()
        r = subprocess.run([sys.executable, *launch, *args], env=env,
                           cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert tune.exists()
        if pkg == "pansvr_tpu_torch":
            assert ("engine tuning loaded" in r.stderr) == (run == 2), run
        outs[run] = (_records(str(out)),
                     _records(str(ori)) if side_channel else None)
    assert len(outs[0][0]) > 0
    assert outs[0] == outs[1] == outs[2]


def test_signal_fq_matches_pipeline(cli_world):
    from pansvr_tpu import pipeline
    from pansvr_tpu_torch import pipeline as port_pipeline

    path = str(cli_world / "signal.fq")
    recs = list(port_pipeline.read_signal_fastq(path))
    assert recs == list(pipeline.read_signal_fastq(path))
    assert len(recs) > 50
    comments = [c for *_, c in recs] + [recs[0][3] + "_STAT_150_200_400_600"]
    for c in comments:
        (a, sa), (b, sb) = (m.parse_signal_comment(c)
                            for m in (pipeline, port_pipeline))
        # the port's OriResult is its own copy of the dataclass
        assert dataclasses.astuple(a) == dataclasses.astuple(b), c
        assert sa == sb, c


class _Parsed(Exception):
    pass


def _cli_surface(main, monkeypatch):
    """{subcommand: sorted positionals and option strings} of a CLI's
    parser, caught as `main` hands it the command line."""
    import argparse

    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        main(["fc_sv"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(o for a in sp._actions
                         for o in (a.option_strings or [a.dest]))
            for name, sp in sub.choices.items()}


def test_cli_accepts_every_jax_subcommand(monkeypatch):
    """The port's parser holds every subcommand of python -m pansvr_tpu
    with the same positionals and flags; the only additions are --device
    on fc_aln, fc_sv and run."""
    from pansvr_tpu.cli.main import main as jax_main
    from pansvr_tpu_torch.cli.main import main

    ours = _cli_surface(main, monkeypatch)
    theirs = _cli_surface(jax_main, monkeypatch)
    assert sorted(ours) == sorted(theirs)
    for cmd, opts in theirs.items():
        extra = ["--device"] if cmd in ("fc_aln", "fc_sv", "run") else []
        assert ours[cmd] == sorted(opts + extra), cmd


def test_cuda_request_without_card_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, idx, _, _ = world
    with pytest.raises(RuntimeError, match="cuda"):
        AlignEngine(idx, device="cuda")


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports with jax and
    the JAX package (pansvr_tpu) blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pansvr_tpu'] = None\n"
        "import pansvr_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'pansvr_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k.split('.')[0] in ('jax', 'pansvr_tpu') "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 10


# the port's layers, lowest first: a module imports no package of the
# layers above its own (function-level imports included)
_UPPER = {("ops", "index", "io", "utils"): ("align", "parallel", "cli"),
          ("align",): ("parallel", "cli")}


def _port_imports(path: str, pkg: str) -> set:
    """The port subpackages (align, cli, ...) a module file imports,
    absolute and relative, at any depth of its code; `pkg` is the
    module's own package (pansvr_tpu_torch.<sub>)."""
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
                names += [mod] if node.module else \
                    [f"{mod}.{a.name}" for a in node.names]
            else:
                names.append(node.module)
    return {n.split(".")[1] for n in names
            if n.startswith("pansvr_tpu_torch.")}


def test_port_layers_import_no_upper_layer():
    """No module under ops/, index/, io/ or utils/ imports align/,
    parallel/ or cli/, and none under align/ imports parallel/ or cli/."""
    root = os.path.join(REPO, "pansvr_tpu_torch")
    seen = 0
    for lower, upper in _UPPER.items():
        for sub in lower:
            for name in sorted(os.listdir(os.path.join(root, sub))):
                if not name.endswith(".py"):
                    continue
                got = _port_imports(os.path.join(root, sub, name),
                                    f"pansvr_tpu_torch.{sub}")
                assert not got & set(upper), (f"{sub}/{name}", got)
                seen += 1
    assert seen >= 20


def test_retier_widens_shapes_on_repeat_rich_reads():
    """Repeat-rich reads (a segment shared by three contigs) with the
    fallback rate forced over the threshold: both engines widen M/S/K/nf
    the same way, agree with each other on every batch, and after the
    widening the port takes no host fallback and equals the host aligner
    (tests/test_engine.py's retier test, held against the JAX engine)."""
    rng = np.random.default_rng(7)
    shared = "".join(rng.choice(list("ACGT"), 900))
    contigs = []
    for i in range(3):
        base = "".join(rng.choice(list("ACGT"), 1400))
        seq = base[:500] + shared + base[500:]
        contigs.append(
            (f"{i}_chr1_{1 + i * 4000}_{len(seq)}_DEL_100_200_"
             f"{(i + 1) * 4000}_sv{i}", seq))
    idx = build_index(contigs, first_level_bases=10)
    reads = []
    for _ in range(3 * 256):
        _, seq = contigs[int(rng.integers(len(contigs)))]
        p = int(rng.integers(400, 500 + 900 - 150))
        reads.append(seq[p : p + 150])
    oris = [OriResult(unmapped=True)] * len(reads)
    eng = AlignEngine(idx, device="cpu")
    jeng = JaxEngine(idx)
    B = 256
    for b in range(3):
        for e in (eng, jeng):
            e._tier_window += [(1024, 1024)] * 2  # simulated heavy batches
        got = eng.align_batch(reads[b * B : (b + 1) * B], oris[:B])
        want = jeng.align_batch(reads[b * B : (b + 1) * B], oris[:B])
        assert _state(eng) == _state(jeng), b
        assert eng._tier_window == jeng._tier_window, b
        for i, (x, y) in enumerate(zip(want, got)):
            _cmp(x, y, f"batch {b} read {i}")
        assert all(s.results for s in got)
    assert eng.cfg.mem_slots > 32, "retier never triggered"
    assert eng._tier_window[-1][0] == 0
    st = eng.align_batch(reads[:32], oris[:32])
    host = HostAligner(idx)
    for i in range(32):
        _cmp(host.align_read(reads[i], oris[i]), st[i], f"r{i}")


@pytest.mark.parametrize("budget", [None, (8, 16)],
                         ids=["budgets", "tiny_budgets"])
def test_device_collect_matches_host_collect(world, budget):
    """collect="device" (select_and_paths + the path-mode glue) equals
    collect="host" and the JAX engine's device collect; with lane
    budgets small enough to spill, the spilled reads take the host path
    and both engines grow collect_mult alike from the reported demand."""
    ds, idx, host, _ = world
    seqs = [s for r in ds.reads[:48] for s in (r.seq1, r.seq2)]
    oris = [OriResult(unmapped=True) for _ in seqs]
    names = list(ds.genome)
    dev = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(collect="device"))
    hst = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(collect="host"))
    jeng = JaxEngine(idx, ori_chrom_names=names,
                     config=JaxConfig(collect="device"))
    if budget:
        dev._collect_budgets = jeng._collect_budgets = lambda n_pad: budget
    a = dev.align_batch(seqs, oris)
    b = hst.align_batch(seqs, oris)
    c = jeng.align_batch(seqs, oris)
    for k in range(len(seqs)):
        _cmp(b[k], a[k], f"read {k} host collect")
        _cmp(c[k], a[k], f"read {k} jax")
    assert _state(dev) == _state(jeng)
    assert (dev.cfg.collect_mult > 1) == bool(budget)
    assert dev.prof["n_fallback"] > 0 if budget else \
        dev.prof["n_fallback"] == 0


def test_tuning_roundtrip(tmp_path, world):
    """save_tuning / load_tuning round trip, and a file written by either
    package loads in the other."""
    ds, idx, host, _ = world
    eng = AlignEngine(idx, device="cpu")
    eng.cfg.nf_mult, eng.cfg.collect_mult, eng._k_spec = 40, 4, 16
    ours = str(tmp_path / "port.json")
    eng.save_tuning(ours)
    jeng = JaxEngine(idx)
    jeng.cfg.nf_mult, jeng.cfg.mem_slots, jeng._k_spec = 20, 64, 32
    theirs = str(tmp_path / "jax.json")
    jeng.save_tuning(theirs)
    for path, src in ((ours, eng), (theirs, jeng)):
        e2 = AlignEngine(idx, device="cpu")
        j2 = JaxEngine(idx)
        assert e2.load_tuning(path) and j2.load_tuning(path)
        assert _state(e2) == _state(j2) == _state(src)
    assert not AlignEngine(idx, device="cpu").load_tuning(
        str(tmp_path / "missing.json"))
