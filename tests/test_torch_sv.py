"""The port's fc_sv path on the CPU against the JAX package's: the contig
DP batcher (plain versions of the extd2 kernels) against the original's
inline native DP, the fc_sv command line (VCF bytes, -D/-d detail), the
port's assembler, and the four places where the port raises for a
missing native symbol while the original falls back to Python."""

import io
import os
import subprocess
import sys
import types
from dataclasses import astuple

import numpy as np
import pytest

from pansvr_tpu.assembly import sv_call as jax_sv
from pansvr_tpu.assembly.assembler import AssemblyManager as JaxAssembler
from pansvr_tpu_torch.assembly import sv_call
from pansvr_tpu_torch.assembly.assembler import AssemblyManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NO_JAX_MAIN = ("import runpy, sys; sys.modules['jax'] = None; "
                "sys.modules['pansvr_tpu'] = None; "
                "runpy.run_module('pansvr_tpu_torch', run_name='__main__')")
Q, T, W = 576, 704, 192


def _contig_problems(rng, n=40):
    """Contig-profile DP requests: mutated copies (substitutions, indels
    up to 30 bp) as fc_sv's contigs against their anchor slice, unrelated
    pairs and diverging prefixes (z-drop), a short query on a long target
    (the band dies), and one request longer than Q and one longer than T
    (the scalar DP)."""
    def rand(k):
        return rng.integers(0, 4, k).astype(np.uint8)

    out = []
    for i in range(n):
        kind = i % 5
        if kind in (0, 1, 2):
            t = rand(int(rng.integers(80, T + 1)))
            q = list(t[int(rng.integers(0, 15)):][:Q])
            for _ in range(int(rng.integers(0, 8))):
                j = int(rng.integers(0, len(q)))
                q[j] = (q[j] + 1) % 4
            for _ in range(int(rng.integers(0, 3))):
                g = int(rng.integers(-30, 31))
                j = int(rng.integers(1, len(q)))
                if g > 0:
                    q[j:j] = list(rand(g))
                else:
                    del q[j : j - g]
            q = np.array(q[:Q], np.uint8)
        elif kind == 3:
            q, t = rand(int(rng.integers(20, Q + 1))), rand(int(rng.integers(20, T + 1)))
        else:
            t = rand(int(rng.integers(300, T + 1)))
            m = int(rng.integers(10, 60))
            q = np.concatenate([t[:m], rand(int(rng.integers(m, Q + 1)) - m)])
        out.append((q, t))
    out.append((rand(12), rand(T)))
    out.append((rand(Q + 24), rand(T)))
    out.append((rand(300), rand(T + 16)))
    return out


def _band_dies(ql, tl, w=132):
    return any(max(0, r - ql + 1, (r - w + 1) >> 1) > min(tl - 1, r, (r + w) >> 1)
               for r in range(ql + tl - 1))


def test_contig_dp_batcher_matches_jax_inline():
    """device="cpu" (the kernels' plain versions) against the JAX
    package's inline native DP on the fields finish_sv and the original's
    device path agree on: max, its end point, z-drop, the CIGAR, and the
    score where the problem did not z-drop."""
    pairs = _contig_problems(np.random.default_rng(2025))
    ours = sv_call.ContigDpBatcher(device="cpu")
    ref = jax_sv.ContigDpBatcher(device=False)
    ids = [(ours.request(q, t), ref.request(q, t)) for q, t in pairs]
    assert all(r is None for r in ours.results)  # resolved by run()
    ours.run()
    n_zdrop = 0
    for k, (a_id, b_id) in enumerate(ids):
        a, b = ours.result(a_id), ref.result(b_id)
        assert (a.max, a.max_q, a.max_t, a.zdropped, a.cigar) == \
            (b.max, b.max_q, b.max_t, b.zdropped, b.cigar), k
        if not b.zdropped:
            assert a.score == b.score, k
        n_zdrop += b.zdropped
    p = ours.prof
    assert p["n_requests"] == len(pairs) and p["n_scalar"] == 2
    assert p["chunks"] == [len(pairs) - 2] and not ours.requests
    assert 0 < n_zdrop < len(pairs) - 5
    assert any(_band_dies(len(q), len(t)) for q, t in pairs)
    assert sum(bool(ours.result(a).cigar) for a, _ in ids) > len(pairs) // 2


def test_contig_dp_batcher_chunks_and_defaults():
    """Chunks hold at most CHUNK problems; the default is the card (a
    missing one raises), and INLINE names the native scalar DP, resolved
    at request time as in the original."""
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, 4, 30).astype(np.uint8),
              rng.integers(0, 4, 40).astype(np.uint8)) for _ in range(7)]
    b = sv_call.ContigDpBatcher(device="cpu")
    b.CHUNK = 3
    ids = [b.request(q, t) for q, t in pairs]
    b.run()
    assert b.prof["chunks"] == [3, 3, 1]
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sv_call.ContigDpBatcher()
        with pytest.raises(RuntimeError, match="cuda"):
            sv_call.SvCaller(None)
    else:
        assert sv_call.ContigDpBatcher().device.type == "cuda"
    inline = sv_call.ContigDpBatcher(sv_call.INLINE)
    assert inline.device is None
    for (q, t), k in zip(pairs, ids):
        assert astuple(inline.result(inline.request(q, t))) == \
            astuple(jax_sv._scalar_contig_dp(q, t))
        assert b.result(k).cigar == inline.results[-1].cigar


@pytest.fixture(scope="module")
def sv_world(tmp_path_factory):
    """A pipeline world (3 DEL/INS, 400 pairs) run through the port's
    pipeline on the CPU: anchors, realigned BAM, status, genome."""
    from pansvr_tpu_torch.io.fasta import write_fasta
    from pansvr_tpu_torch.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from pansvr_tpu_torch.utils.simulate import make_dataset, write_sim_bam

    d = tmp_path_factory.mktemp("torch_sv")
    ds = make_dataset(seed=77, n_sv=3, n_pairs=400, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 100_000}, err_rate=0.0)
    write_fasta(str(d / "genome.fa"), ds.genome.items(), width=60)
    w = VCFWriter(str(d / "svs.vcf"),
                  minimal_header([(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    write_sim_bam(ds, str(d / "sim.bam"))
    run_pipeline(str(d / "svs.vcf"), str(d / "genome.fa"), str(d / "sim.bam"),
                 str(d / "work"), PipelineConfig(first_level_bases=11),
                 device="cpu")
    return d


@pytest.mark.parametrize("detail", [False, True], ids=["vcf", "detail"])
def test_fc_sv_cli_matches_jax_cli(sv_world, detail):
    """python -m pansvr_tpu_torch fc_sv --device cpu (jax and the JAX
    package blocked) writes the VCF of python -m pansvr_tpu fc_sv byte for
    byte; with -D -d the detail channel (stderr) is identical too."""
    d, work = sv_world, sv_world / "work"
    outs = {}
    for pkg, launch, extra in (
            ("jax", ["-m", "pansvr_tpu"], []),
            ("torch", ["-c", _NO_JAX_MAIN], ["--device", "cpu"])):
        out = d / f"{pkg}_{detail}.vcf"
        args = ["fc_sv", str(work / "anchors.fa"), str(work / "realigned.bam"),
                str(d / "genome.fa"), "-o", str(out),
                "-r", str(work / "status.txt"), *extra]
        if detail:
            args += ["-D", "-d"]
        r = subprocess.run([sys.executable, *launch, *args], cwd=REPO,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"),
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        outs[pkg] = (out.read_bytes(), r.stderr)
    assert outs["jax"] == outs["torch"]
    vcf, err = outs["torch"]
    assert b"\tPASS\t" in vcf
    assert ("event matrix" in err) == detail and ("read pileup" in err) == detail


def test_fc_sv_entry_point_runs_the_dp_batched(sv_world):
    """run_fc_sv returns the batcher: every DP request went through the
    chunked device path (here the plain versions)."""
    from pansvr_tpu_torch.cli.main import parse_args, run_fc_sv

    work = sv_world / "work"
    verdicts, dp = run_fc_sv(parse_args([
        "fc_sv", str(work / "anchors.fa"), str(work / "realigned.bam"),
        str(sv_world / "genome.fa"), "-o", str(sv_world / "entry.vcf"),
        "-r", str(work / "status.txt"), "--device", "cpu"]))
    assert sum(v.passed for v in verdicts) >= 1
    p = dp.prof
    assert p["n_requests"] >= 1 and p["n_chunks"] == 1
    assert sum(p["chunks"]) == p["n_requests"] - p["n_scalar"]
    assert dp.first_chunk.shape == (p["chunks"][0], Q + T + 8)


def test_fc_sv_refuses_a_missing_card(sv_world):
    import torch

    from pansvr_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    work = sv_world / "work"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["fc_sv", str(work / "anchors.fa"), str(work / "realigned.bam"),
              str(sv_world / "genome.fa"), "-o", os.devnull])


def test_assembler_matches_jax(sv_world):
    """The port's assembler (native word-length passes only) gives the
    original's contigs and action journals on the world's reads."""
    from pansvr_tpu_torch.io.bam import BamReader

    with BamReader(str(sv_world / "work" / "realigned.bam")) as rd:
        reads = [r.seq for r in rd][:120]
    ours, ref = AssemblyManager(), JaxAssembler()
    for s in reads:
        ours.add_read(s)
        ref.add_read(s)
    a, b = ours.assemble(), ref.assemble()
    assert a and len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.seq, x.support_reads, x.actions, x.ending_reason,
                x.new_support_read) == (y.seq, y.support_reads, y.actions,
                                        y.ending_reason, y.new_support_read)


@pytest.mark.parametrize("where", ["contig_dp", "sv_read_index", "assembler",
                                   "denovo_dp"])
def test_missing_native_symbol_raises(sv_world, monkeypatch, where):
    """Where the original falls back to Python when the native library
    lacks a symbol, the port raises."""
    from pansvr_tpu_torch.align import native_glue
    from pansvr_tpu_torch.assembly import denovo

    monkeypatch.setattr(native_glue, "get_lib", lambda: types.SimpleNamespace())
    codes = np.zeros(30, np.uint8)
    with pytest.raises(RuntimeError, match="rebuild it"):
        if where == "contig_dp":
            sv_call._scalar_contig_dp(codes, codes)
        elif where == "sv_read_index":
            sv_call.SvReadIndex(str(sv_world / "work" / "realigned.bam"), [])
        elif where == "assembler":
            am = AssemblyManager()
            am.add_read("ACGT" * 20)
            am.assemble()
        else:
            denovo._dp(codes, codes, **sv_call.CONTIG_DP)


def test_detail_channel_in_process_matches_jax(sv_world):
    """SvCaller's -D/-d renderings through detail_out: the port with the
    batched DP and the original with its inline DP write the same text."""
    from pansvr_tpu.io.fasta import Faidx as JaxFaidx
    from pansvr_tpu.io.fasta import read_fasta as jax_read_fasta
    from pansvr_tpu_torch.io.fasta import Faidx, read_fasta

    work = sv_world / "work"
    texts = []
    for mod, rf, fx, dp in (
            (jax_sv, jax_read_fasta, JaxFaidx, None),
            (sv_call, read_fasta, Faidx, sv_call.ContigDpBatcher("cpu"))):
        seqs = rf(str(work / "anchors.fa"))
        sf = mod.SVRefSequence(list(seqs), seqs, fx(str(sv_world / "genome.fa")),
                               ["chr1"])
        out = io.StringIO()
        opts = mod.SvCallOptions(print_detail=True, depth_detail=True)
        _, recs = mod.run_sv_calling(str(work / "realigned.bam"), sf, opts,
                                     dp=dp, detail_out=out)
        texts.append((out.getvalue(), [r.to_line() for r in recs]))
    assert texts[0] == texts[1]
    assert "read pileup" in texts[0][0] and texts[0][1]


def test_ops_to_cigar_skip_matches_the_loop_decoder():
    """The port's vectorized decoder against the original's loop
    (pansvr_tpu/ops/extd2_pallas.py) on random op rows and final ends."""
    from pansvr_tpu.ops.extd2_pallas import ops_to_cigar_skip as loop
    from pansvr_tpu_torch.ops.extd2 import ops_to_cigar_skip

    rng = np.random.default_rng(17)
    for _ in range(3000):
        row = rng.choice(np.array([0, 0, 0, 1, 2, 3], np.int8),
                         int(rng.integers(0, 48)))
        i, j = (int(x) for x in rng.integers(-1, 4, 2))
        assert ops_to_cigar_skip(row, i, j) == loop(row, i, j), (row, i, j)
