"""The port's whole pipeline (`run`), its fc_sv fan-out, its on-card
self-check and its host subcommands on the CPU, against the JAX
package's: identical output files from the same inputs."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# torch's intra-op threads slow the plain path's many small ops several
# fold, most of all beside other test processes: one thread, here and in
# the processes the tests start
torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """4 DEL/INS on 120 kbp, 600 pairs; the input VCF names three of the
    SVs (the fourth leaves unexplained pairs for the de novo caller).
    Both packages' run_pipeline ran on it, each in its own work dir."""
    from pansvr_tpu.io.fasta import write_fasta
    from pansvr_tpu.io.vcf import VCFWriter, minimal_header
    from pansvr_tpu.pipeline import PipelineConfig as JaxConfig
    from pansvr_tpu.pipeline import run_pipeline as jax_run
    from pansvr_tpu.utils.simulate import make_dataset, write_sim_bam
    from pansvr_tpu_torch.pipeline import PipelineConfig, run_pipeline

    d = tmp_path_factory.mktemp("torch_pipeline")
    ds = make_dataset(seed=78, n_sv=4, n_pairs=600, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 120_000}, err_rate=0.0)
    p = {k: str(d / f) for k, f in (("genome", "genome.fa"), ("vcf", "svs.vcf"),
                                     ("bam", "sim.bam"))}
    write_fasta(p["genome"], ds.genome.items(), width=60)
    w = VCFWriter(p["vcf"], minimal_header(
        [(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records[:3]:
        w.write(r)
    w.close()
    write_sim_bam(ds, p["bam"])
    args = (p["vcf"], p["genome"], p["bam"])
    p["jax_vcf"] = jax_run(*args, str(d / "jax"),
                           JaxConfig(first_level_bases=11))
    p["vcf_out"] = run_pipeline(*args, str(d / "port"),
                                PipelineConfig(first_level_bases=11),
                                device="cpu")
    p["jax"], p["port"], p["dir"] = str(d / "jax"), str(d / "port"), d
    return p


def _body(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_run_pipeline_matches_jax(world):
    """result.vcf byte-identical; so are the stage files before it."""
    assert _body(world["vcf_out"]) == _body(world["jax_vcf"])
    assert b"\tPASS\t" in _body(world["vcf_out"])
    for f in ("anchors.fa", "signal.fq", "status.txt"):
        assert _body(os.path.join(world["port"], f)) == \
            _body(os.path.join(world["jax"], f)), f


def test_run_cli_matches_jax_cli(world, tmp_path):
    """python -m pansvr_tpu_torch run --device cpu == python -m pansvr_tpu
    run, byte for byte (the port with jax and the JAX package blocked)."""
    no_jax = ("import runpy, sys; sys.modules['jax'] = None; "
              "sys.modules['pansvr_tpu'] = None; "
              "runpy.run_module('pansvr_tpu_torch', run_name='__main__')")
    work = tmp_path / "cli"
    r = subprocess.run(
        [sys.executable, "-c", no_jax, "run", world["genome"], world["vcf"],
         world["bam"], str(work), "--first-level", "11", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(work / "result.vcf")
    assert _body(work / "result.vcf") == _body(world["jax_vcf"])


def _fanout(pkg, world, out, **kw):
    import importlib

    fo = importlib.import_module(f"{pkg}.parallel.fanout")
    w = world["port"]
    return fo, lambda: fo.run_sv_fanout(
        f"{w}/anchors.fa", f"{w}/realigned.bam", world["genome"], out,
        n_shards=2, status_file=f"{w}/status.txt", **kw)


def test_sv_fanout_matches_jax(world, tmp_path):
    """2 fc_sv worker processes in each package: the same merged VCF, also
    when shard 0's first attempt is killed (re-dispatched), and a shard
    that keeps failing raises."""
    outs = {}
    for pkg, kw in (("pansvr_tpu", {}), ("pansvr_tpu_torch",
                                         dict(device="cpu"))):
        _, run = _fanout(pkg, world, str(tmp_path / f"{pkg}.vcf"), **kw)
        outs[pkg] = _body(run())
    assert outs["pansvr_tpu"] == outs["pansvr_tpu_torch"]
    assert outs["pansvr_tpu"].count(b"\n") > 5

    fo, run = _fanout("pansvr_tpu_torch", world, str(tmp_path / "retry.vcf"),
                      device="cpu")
    real_spawn = fo._spawn
    sabotaged = {"done": False}

    def killing_spawn(cmd, env):
        pr = real_spawn(cmd, env)
        if not sabotaged["done"]:
            sabotaged["done"] = True
            pr.kill()
        return pr

    fo._spawn = killing_spawn
    try:
        merged = run()
    finally:
        fo._spawn = real_spawn
    assert sabotaged["done"] and _body(merged) == outs["pansvr_tpu"]

    fo._spawn = lambda cmd, env: real_spawn(
        [sys.executable, "-c", "raise SystemExit(3)"], env)
    try:
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            _fanout("pansvr_tpu_torch", world, str(tmp_path / "fail.vcf"),
                    device="cpu")[1]()
    finally:
        fo._spawn = real_spawn


def test_onchip_parity_quick_matches_jax_cases():
    """The self-check on the plain versions passes and checks the JAX
    gate's cases for the same seed."""
    from pansvr_tpu.ops.onchip_check import run_onchip_parity as jax_gate
    from pansvr_tpu_torch.ops.onchip_check import run_onchip_parity

    ours = run_onchip_parity(quick=True, device="cpu")
    assert ours == jax_gate(quick=True, interpret=True)
    assert ours["extd2_aln"] > 0


def test_onchip_sv_profile_at_the_check_window():
    """The contig profile at W = 256 (the full gate's second case set) on
    the plain versions, against the oracle."""
    from pansvr_tpu_torch.ops.onchip_check import SV, _fuzz_pairs, check_extd2

    pairs = _fuzz_pairs(np.random.default_rng(11), 12)
    assert check_extd2(pairs, SV, device="cpu") == len(pairs)


def test_check_extd2_counts_cases_and_raises_on_a_wrong_result(
        monkeypatch):
    """check_extd2 on the plain versions returns the cases it checked for
    the realigner's and the contig profile, and raises on the first case
    whose forward score or traceback differs from the oracle."""
    from pansvr_tpu_torch.ops import extd2_cuda as ec
    from pansvr_tpu_torch.ops.onchip_check import (
        ALN, SV, _fuzz_pairs, check_extd2)

    pairs = _fuzz_pairs(np.random.default_rng(12), 6)
    for params in (ALN, SV):
        assert check_extd2(pairs, params, device="cpu") == len(pairs)
    fwd, tb = ec.extd2_fwd, ec.extd2_traceback

    def fwd_off_by_one(*args):
        out = fwd(*args)
        return out._replace(max=out.max + (torch.arange(len(out.max)) == 3))

    monkeypatch.setattr(ec, "extd2_fwd", fwd_off_by_one)
    with pytest.raises(AssertionError, match="case 3 max"):
        check_extd2(pairs, ALN, device="cpu")

    def tb_without_ops(*args):
        ops, i_f, j_f = tb(*args)
        return torch.full_like(ops, 3), i_f, j_f

    monkeypatch.setattr(ec, "extd2_fwd", fwd)
    monkeypatch.setattr(ec, "extd2_traceback", tb_without_ops)
    with pytest.raises(AssertionError, match="case 0 cigar"):
        check_extd2(pairs, ALN, device="cpu")


def _files(path):
    if os.path.isfile(path):
        return {"": _body(path)}
    return {os.path.relpath(os.path.join(b, n), path): _body(os.path.join(b, n))
            for b, _, ns in os.walk(path) for n in ns}


# (name, argv with {placeholders}, stdin, outputs to compare besides stdout)
CASES = [
    ("fc_anchor_ref", ["fc_anchor_ref", "{genome}", "{vcf}"], None, []),
    ("fc_index", ["fc_index", "{jax}/anchors.fa", "{out}/idx",
                  "--first-level", "10"], None, ["idx"]),
    ("fc_signal", ["fc_signal", "{bam}", "-o", "{out}/signal.fq", "-s",
                   "{out}/status.txt", "-U", "-D"], None,
     ["signal.fq", "status.txt"]),
    ("assembly_test", ["assembly_test"], "reads", []),
    ("sv_calling", ["sv_calling", "{genome}", "{out}/ori_sorted.bam", "-o",
                    "{out}/denovo.vcf"], None, ["denovo.vcf"]),
    ("tools_bam2Fastq", ["tools", "bam2Fastq", "{bam}", "{out}/r.fq"], None,
     ["r.fq"]),
    ("tools_isize_count", ["tools", "isize_count", "{bam}"], None, []),
    ("tools_vcf_dump", ["tools", "vcf_dump", "{vcf}", "{out}/dels.vcf", "ALL",
                        "DEL", "ALL"], None, ["dels.vcf"]),
    ("tools_combine_sort_vcf", ["tools", "combine_sort_vcf", "{out}/m.vcf",
                                "{vcf}", "{jax}/result.vcf"], None, ["m.vcf"]),
    ("tools_vcf_compare", ["tools", "vcf_compare", "{vcf}", "{jax}/result.vcf"],
     None, []),
    ("tools_randomGenerateSV", ["tools", "randomGenerateSV", "{genome}", "3",
                                "5"], None, []),
    ("tools_bamDump", ["tools", "bamDump", "{bam}", "{out}/head.bam", "9"], None,
     ["head.bam"]),
]


@pytest.mark.parametrize("name,argv,stdin,files", CASES,
                         ids=[c[0] for c in CASES])
def test_cli_subcommand_matches_jax(world, tmp_path, monkeypatch, capsys,
                                    name, argv, stdin, files):
    """Each host subcommand of both command lines, in process, on the
    same inputs: identical standard output and output files."""
    import io

    from pansvr_tpu.cli.main import main as jax_main
    from pansvr_tpu_torch.cli.main import main as port_main

    if name == "sv_calling":
        from pansvr_tpu.io.bai import sort_bam

        sort_bam(os.path.join(world["jax"], "output_ori.bam"),
                 str(tmp_path / "ori_sorted.bam"))
    reads = None
    if stdin:
        from pansvr_tpu.io.bam import BamReader

        with BamReader(os.path.join(world["jax"], "realigned.bam")) as rd:
            reads = "".join(r.seq + "\n" for r in rd)
    results = []
    for pkg, fn in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / pkg
        out.mkdir()
        if name == "sv_calling":
            os.link(tmp_path / "ori_sorted.bam", out / "ori_sorted.bam")
        if reads is not None:
            monkeypatch.setattr(sys, "stdin", io.StringIO(reads))
        fn([a.format(out=out, **world) for a in argv])
        got = {"stdout": capsys.readouterr().out}
        for f in files:
            got[f] = _files(str(out / f))
        results.append(got)
    assert results[0] == results[1]
    assert any(results[0].values())
    if name == "sv_calling":
        assert results[0]["denovo.vcf"][""].count(b"\n") > 3
