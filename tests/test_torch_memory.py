"""The port's host-memory probe (pansvr_tpu_torch/utils/memory.py) on a
fixture smaps text, and the engine's resident-set snapshots (at its
start, once built and at each stream's end) on a small world on the CPU,
through both stream loops."""

import mmap
import os

import pytest
import torch

from pansvr_tpu_torch.utils import memory

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")

# one mapping of each kind, a library in two mappings and one deleted,
# and paths that hold ".so" without being a library
SMAPS = """\
55d0c0a00000-55d0c0c00000 rw-p 00000000 00:00 0                          [heap]
Size:               2048 kB
Rss:                1024 kB
Pss:                1024 kB
VmFlags: rd wr mr mw me ac sd
7f0000000000-7f0000100000 r-xp 00000000 08:01 1234                       /usr/lib/libtorch_cuda.so
Size:               1024 kB
Rss:                 768 kB
VmFlags: rd ex mr mw me sd
7f0000100000-7f0000200000 r--p 00100000 08:01 1234                       /usr/lib/libtorch_cuda.so
Rss:                 256 kB
7f0000200000-7f0000300000 r-xp 00000000 08:01 1235                       /usr/lib/libcudnn.so.9.1.0
Rss:                 512 kB
7f0000300000-7f0000400000 r-xp 00000000 08:01 1236                       /tmp/x/_C.cpython-312-x86_64-linux-gnu.so (deleted)
Rss:                 128 kB
7f0000400000-7f0000500000 rw-s 00000000 00:05 77                         /dev/nvidia0
Rss:                 64 kB
7f0000500000-7f0000600000 rw-s 00000000 00:05 78                         /dev/nvidiactl
Rss:                 32 kB
7f0000600000-7f0000700000 r--p 00000000 08:01 99                         /data/rdbg/ent_key.npy
Rss:                 2048 kB
7f0000700000-7f0000800000 r--p 00000000 08:01 98                         /run/app.sock.d/cache
Rss:                 16 kB
7f0000800000-7f0000900000 rw-p 00000000 00:00 0
Rss:                 4096 kB
7f0000900000-7f0000a00000 rw-p 00000000 00:00 0                          [anon:pinned]
Rss:                 8 kB
7ffd00000000-7ffd00021000 rw-p 00000000 00:00 0                          [stack]
Rss:                 4 kB
"""
STATUS = "Name:\tpython\nVmHWM:\t   9000 kB\nVmRSS:\t    8956 kB\n"
KIB = 1024 / 2 ** 30


@pytest.fixture
def proc_files(tmp_path):
    (tmp_path / "smaps").write_text(SMAPS)
    (tmp_path / "status").write_text(STATUS)
    return str(tmp_path / "smaps"), str(tmp_path / "status")


def test_probe_buckets_a_fixture_smaps(proc_files):
    smaps, status = proc_files
    m = memory.rss_by_kind(smaps, status, top=2)
    assert m["kinds"] == pytest.approx(dict(
        anon=(1024 + 4096 + 8 + 4) * KIB, lib=(768 + 256 + 512 + 128) * KIB,
        dev=(64 + 32) * KIB, file=(2048 + 16) * KIB))
    # summed over a library's mappings, the most first, `top` of them
    assert m["top"] == [("/usr/lib/libtorch_cuda.so", pytest.approx(1024 * KIB)),
                        ("/usr/lib/libcudnn.so.9.1.0", pytest.approx(512 * KIB))]
    assert m["vmrss"] == pytest.approx(8956 * KIB)
    assert sum(m["kinds"].values()) == pytest.approx(m["vmrss"])
    assert 0 <= m["s"] < 1.0


def test_probe_reads_nothing_without_proc(tmp_path, proc_files):
    smaps, status = proc_files
    assert memory.rss_by_kind(str(tmp_path / "no_smaps"), status) is None
    assert memory.vmrss_gib(str(tmp_path / "no_status")) is None
    m = memory.rss_by_kind(smaps, str(tmp_path / "no_status"))
    assert m["vmrss"] is None and m["kinds"]["lib"] > 0


def test_probe_on_this_process():
    """This process's smaps sums to its VmRSS, and rss_growth sees 64 MiB
    touched inside its block. (The read's seconds are checked against a
    loose bound here, beside other test processes; a card's host is held
    to 0.1 s by the benchmark's runs.)"""
    m = memory.rss_by_kind()
    assert m["kinds"]["lib"] > 0 and m["kinds"]["anon"] > 0
    assert sum(m["kinds"].values()) == pytest.approx(m["vmrss"], rel=0.05)
    assert m["s"] < 1.0
    prof = {}
    with mmap.mmap(-1, 1 << 26) as fresh:     # pages no allocator reuses
        with memory.rss_growth(prof, "grown"):
            fresh.write(b"\1" * (1 << 26))
    assert prof["grown"] >= 0.05


@pytest.mark.parametrize("active_peak,want", [(3 << 20, 3 / 1024),
                                               (9 << 30, None)])
def test_pinned_counters(monkeypatch, active_peak, want):
    """The host allocator's owned bytes and blocks, and its active peak
    only where it is at most the owned peak (blocks checked out are owned
    ones)."""
    stats = {"allocated_bytes.current": 4 << 20,
             "allocated_bytes.peak": 4 << 20,
             "active_bytes.peak": active_peak, "allocations.current": 5}
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: stats,
                        raising=False)
    got = memory.pinned_host()
    assert got.pop("pinned_host_gib") == 4 / 1024
    assert got.pop("n_pinned_blocks") == 5.0
    assert got == ({} if want is None else {"pinned_active_peak_gib": want})


@pytest.fixture(scope="module")
def small_world():
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import (AnchorConfig,
                                                 build_anchor_contigs)
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=40, n_sv=5, n_pairs=120, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    batches = [(seqs[i : i + 48], [OriResult(unmapped=True)] * 48)
               for i in range(0, 144, 48)]
    return idx, list(ds.genome), batches


SNAPSHOT = [f"rss_{pt}_{k}_gib" for pt in ("start", "built", "end")
            for k in memory.KINDS]


@pytest.mark.parametrize("depth", [3, 1])
def test_engine_snapshots_through_a_stream(small_world, monkeypatch, depth):
    """Every snapshot counter is a number; the start's peak is at most the
    built engine's; the end's kinds sum to its VmRSS; the pinned counters
    and the graph warm-ups' growth read 0 off a card; a second stream
    overwrites the end snapshot."""
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig

    idx, names, batches = small_world
    # every DP problem to the host's scalar DP (no size class holds one):
    # the plain path's DP kernels issue many small ops, slow here
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                      config=EngineConfig(stream_depth=depth, dp_q=1, dp_t=1))
    assert "rss_end_gib" not in eng.prof
    assert len(list(eng.align_stream(iter(batches)))) == len(batches)
    p = eng.prof
    for k in SNAPSHOT + ["rss_start_gib", "rss_built_gib", "rss_end_gib"]:
        assert isinstance(p[k], float) and p[k] >= 0, k
    assert p["rss_end_lib_gib"] > 0 and p["rss_end_anon_gib"] > 0
    assert all(isinstance(v, (int, float)) for v in p.values())
    assert p["rss_start_gib"] <= p["rss_built_gib"]
    assert p["engine_rss_gib"] == pytest.approx(
        p["rss_built_gib"] - p["rss_start_gib"])
    end = sum(p[f"rss_end_{k}_gib"] for k in memory.KINDS)
    assert end == pytest.approx(p["rss_end_gib"], rel=0.05)
    assert all(p[k] == 0.0 for k in memory.PINNED)     # nothing pinned
    assert p["warmup_rss_gib"] == p["capture_rss_gib"] == 0.0  # no graphs
    assert set(eng.mem) == {"start", "built", "end"}
    assert all(0 < eng.mem[pt]["s"] < 1.0 for pt in eng.mem)
    assert eng.mem["end"]["top"] and all(
        ".so" in path for path, _ in eng.mem["end"]["top"])

    fake = dict(kinds=dict.fromkeys(memory.KINDS, 0.25),
                top=[("/x/libfake.so", 0.25)], vmrss=1.0, s=0.001)
    monkeypatch.setattr(memory, "rss_by_kind", lambda: fake)
    start = {k: p[k] for k in SNAPSHOT if "_start_" in k}
    list(eng.align_stream(iter(batches[:1])))
    assert all(p[f"rss_end_{k}_gib"] == 0.25 for k in memory.KINDS)
    assert p["rss_end_gib"] == 1.0
    assert eng.mem["end"]["top"] == fake["top"]
    assert {k: p[k] for k in start} == start
