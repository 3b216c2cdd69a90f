"""The port's own copies of the host modules (anchor, index, io, signal,
simulate) against the JAX package's originals: one seed, one tiny world
built by each package in its own directory, byte-identical files. The
copies differ from the originals in one intended way: the port's native
library loaders (BGZF codec, engine glue) raise where the originals fall
back to Python quietly."""

import importlib
import os

import pytest

PACKAGES = ("pansvr_tpu", "pansvr_tpu_torch")


def _build(pkg: str, d: str) -> dict:
    """genome FASTA + SV VCF -> anchor FASTA -> index directory; simulated
    BAM -> signal FASTQ + status, all with `pkg`'s modules."""
    m = {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "anchor.builder", "index.builder", "index.store", "io.fasta",
        "io.vcf", "signal.extract", "utils.simulate")}
    sim, fasta, vcf = m["utils.simulate"], m["io.fasta"], m["io.vcf"]
    os.makedirs(d)
    p = {k: os.path.join(d, f) for k, f in (
        ("genome", "genome.fa"), ("vcf", "svs.vcf"), ("anchors", "anchors.fa"),
        ("index", "rdbg"), ("bam", "sim.bam"), ("signal", "signal.fq"),
        ("status", "status.sam"))}
    ds = sim.make_dataset(seed=31, n_sv=6, n_pairs=200, types=("DEL", "INS"),
                          chrom_lengths={"chr1": 120_000})
    fasta.write_fasta(p["genome"], ds.genome.items(), width=60)
    w = vcf.VCFWriter(p["vcf"], vcf.minimal_header(
        [(c, len(s)) for c, s in ds.genome.items()]))
    for r in ds.vcf_records:
        w.write(r)
    w.close()
    with open(p["anchors"], "w") as fh:
        m["anchor.builder"].run_anchor_ref(p["vcf"], fasta.Faidx(p["genome"]),
                                           fh)
    contigs = list(fasta.iter_fasta(p["anchors"]))
    assert contigs
    m["index.store"].save_index(
        m["index.builder"].build_index(contigs, first_level_bases=10),
        p["index"])
    sim.write_sim_bam(ds, p["bam"])
    ext = m["signal.extract"]
    stats = ext.compute_stats(p["bam"])
    with open(p["status"], "w") as fh:
        fh.write(stats.status_file_text())
    with open(p["signal"], "w") as fh:
        ext.extract_signal(p["bam"], fh, stats=stats, opts=ext.SignalOptions(
            discard_both_full_match=True, not_using_filter=True))
    return p


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_copies")
    return [_build(pkg, str(root / pkg)) for pkg in PACKAGES]


def _files(path: str) -> dict:
    """{relative name: bytes} of a file, or of every file under a
    directory."""
    if os.path.isfile(path):
        with open(path, "rb") as fh:
            return {"": fh.read()}
    out = {}
    for base, _, names in os.walk(path):
        for n in names:
            f = os.path.join(base, n)
            with open(f, "rb") as fh:
                out[os.path.relpath(f, path)] = fh.read()
    return out


@pytest.mark.parametrize("what", ["vcf", "anchors", "index", "bam", "signal",
                                  "status"])
def test_port_host_copies_write_identical_files(worlds, what):
    ref, port = (_files(w[what]) for w in worlds)
    assert ref and all(ref.values()), what
    assert sorted(ref) == sorted(port), what
    for name in ref:
        assert ref[name] == port[name], f"{what}/{name}"


@pytest.mark.parametrize("case", ["missing", "unloadable"])
@pytest.mark.parametrize("mod", ["io.native_bgzf", "align.native_glue"])
def test_port_native_library_is_required(tmp_path, monkeypatch, mod, case):
    m = importlib.import_module(f"pansvr_tpu_torch.{mod}")
    path = tmp_path / "lib.so"
    if case == "unloadable":
        path.write_bytes(b"not a shared library")
    monkeypatch.setattr(m, "_LIB_PATH", str(path))
    monkeypatch.setattr(m, "_lib", None)
    with pytest.raises(RuntimeError, match={"missing": "is missing",
                                            "unloadable": "does not load"}[case]):
        m.get_lib()


def test_port_bgzf_writer_raises_without_codec(tmp_path, monkeypatch):
    from pansvr_tpu_torch.io import bgzf, native_bgzf

    monkeypatch.setattr(native_bgzf, "_LIB_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(native_bgzf, "_lib", None)
    w = bgzf.BGZFWriter(str(tmp_path / "out.gz"))
    w.write(b"ACGT" * 100)
    with pytest.raises(RuntimeError, match="BGZF codec"):
        w.close()


class _FailingCodec:
    """A BGZF codec library whose calls all return an error code."""

    def __init__(self, with_at: bool):
        self.bgzf_compress_blocks = lambda *a: -3
        self.bgzf_decompress_blocks = lambda *a: -3
        if with_at:
            self.bgzf_decompress_blocks_at = lambda *a: -3


@pytest.mark.parametrize("call", ["compress", "decompress", "decompress_at"])
def test_port_bgzf_codec_error_raises(monkeypatch, call):
    """The port's codec binding raises on a negative return code (the
    original returns None, and its BGZF layer then falls back to zlib)."""
    from pansvr_tpu_torch.io import native_bgzf

    monkeypatch.setattr(native_bgzf, "get_lib",
                        lambda: _FailingCodec(call == "decompress_at"))
    with pytest.raises(RuntimeError, match="codec failed"):
        if call == "compress":
            native_bgzf.compress(b"ACGT" * 100)
        else:
            # one 28-byte block whose ISIZE trailer (last 4 bytes) is 0
            native_bgzf.decompress_blocks(bytes(28), [0], [28])
