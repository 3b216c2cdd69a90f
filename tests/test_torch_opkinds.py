"""The ATen op-kind recorder (utils/opkinds.py) on small CPU programs, the
engine's record of its build's kinds, and the CPU's per-batch programs:
on the CPU they run as PyTorch ops (the plain programs), never through
the card's kernels."""

import os

import pytest
import torch

from pansvr_tpu_torch.utils.opkinds import OpKinds

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")


def test_op_kinds_of_a_small_program():
    """Each overload the block dispatches on the device type, once, with a
    first-use growth; composite ops show as what they are made of, a
    no-op conversion not at all; a second entry adds; another device
    type's recorder sees nothing of the CPU's ops."""
    kinds, cuda = OpKinds("cpu"), OpKinds("cuda")
    with kinds, cuda:
        a = torch.arange(16)
        b = torch.sort(a * 3 % 7, stable=True).values
        c = (b + 1).to(torch.int64).contiguous()
        d = torch.cumsum(c[:8], 0)
    assert set(kinds.kinds) == {
        "aten::arange", "aten::mul.Tensor", "aten::remainder.Scalar",
        "aten::sort.stable", "aten::add.Tensor", "aten::slice.Tensor",
        "aten::cumsum"}
    assert all(isinstance(v, float) for v in kinds.kinds.values())
    assert not cuda.kinds
    first = OpKinds("cpu")
    with first:
        torch.arange(4) + 1
    with kinds:
        torch.where(d > 3, d, 0)
    assert kinds.new_since(first).keys() >= {"aten::sort.stable",
                                             "aten::gt.Scalar",
                                             "aten::where.self"}
    assert "aten::add.Tensor" not in kinds.new_since(first)
    assert torch.equal(d, torch.cumsum((torch.sort(torch.arange(16) * 3 % 7,
                                                   stable=True).values + 1)
                                       [:8], 0))


@pytest.fixture(scope="module")
def small_world():
    from pansvr_tpu_torch.align.host_align import OriResult
    from pansvr_tpu_torch.anchor.builder import (AnchorConfig,
                                                 build_anchor_contigs)
    from pansvr_tpu_torch.index.builder import build_index
    from pansvr_tpu_torch.utils.simulate import DictGenome, make_dataset

    ds = make_dataset(seed=40, n_sv=5, n_pairs=60, types=("DEL", "INS"),
                      chrom_lengths={"chr1": 150_000})
    contigs = list(build_anchor_contigs(
        ds.vcf_records, DictGenome(ds.genome), AnchorConfig()))
    idx = build_index([(c.name, c.seq) for c in contigs], first_level_bases=11)
    seqs = [s for r in ds.reads for s in (r.seq1, r.seq2)]
    return idx, list(ds.genome), seqs, [OriResult(unmapped=True)] * len(seqs)


def test_engine_on_the_cpu_runs_the_plain_programs(small_world, monkeypatch):
    """A CPU engine records its build's op kinds (the index derivation's
    among them), has no graph warm-ups to count, and runs every batch
    through the plain programs: the card's kernel wrappers are never
    called. The phase print names the kinds."""
    from pansvr_tpu_torch.align.engine import AlignEngine, EngineConfig
    from pansvr_tpu_torch.cli.main import op_kinds_line
    from pansvr_tpu_torch.ops import front_cuda

    def refuse(*a, **k):
        raise AssertionError("a card kernel wrapper ran on the CPU")

    for name in ("front", "chain", "collect", "chain_program", "dp_program"):
        monkeypatch.setattr(front_cuda, name, refuse)
    idx, names, seqs, oris = small_world
    for collect in ("device", "host"):
        eng = AlignEngine(idx, ori_chrom_names=names, device="cpu",
                          config=EngineConfig(collect=collect),
                          op_kinds=True)
        states = eng.align_batch(seqs, oris)
        assert any(s.results for s in states)
        assert eng.prof["n_dp_chunks"] > 0
        assert {"aten::searchsorted.Tensor", "aten::unique_consecutive",
                "aten::repeat_interleave.Tensor"} <= set(eng.build_ops.kinds)
        assert eng.prof["n_warmup_new_op_kinds"] == 0
        line = op_kinds_line(eng)
        assert line.startswith("ATen op kinds on the device: engine build "
                               f"{len(eng.build_ops.kinds)}, graph warm-ups 0")


def test_op_kinds_recorder_imports_no_compiler():
    """Entering the recorder and dispatching under it loads neither
    torch._dynamo nor sympy (TorchDispatchMode's own wrapper of
    __torch_dispatch__ imports both on its first call: seconds of
    set-up and hundreds of MiB that the engine build would carry)."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from pansvr_tpu_torch.utils.opkinds import OpKinds\n"
            "k = OpKinds('cpu')\n"
            "with k:\n"
            "    torch.arange(8).sort()\n"
            "assert 'aten::sort' in k.kinds, k.kinds\n"
            "print(sorted(m for m in ('torch._dynamo', 'sympy')"
            " if m in sys.modules))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_engine_records_no_op_kinds_unless_asked(small_world, monkeypatch):
    """Without op_kinds (the default, and fc_aln without --trace) the
    engine enters no dispatch mode: nothing is recorded, no mode is
    active while it runs a batch's front, and the phase print says
    so."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from pansvr_tpu_torch.align import programs
    from pansvr_tpu_torch.align.engine import AlignEngine
    from pansvr_tpu_torch.cli.main import op_kinds_line

    modes = []
    orig = programs.front_program_plain

    def spy(*a, **k):
        modes.append(_get_current_dispatch_mode())
        return orig(*a, **k)

    monkeypatch.setattr(programs, "front_program_plain", spy)
    idx, names, seqs, oris = small_world
    eng = AlignEngine(idx, ori_chrom_names=names, device="cpu")
    assert eng.build_ops is None and eng._programs is None
    states = eng.align_batch(seqs, oris)
    assert any(s.results for s in states)
    assert modes and modes == [None] * len(modes)
    assert eng.prof["n_warmup_new_op_kinds"] == 0
    assert op_kinds_line(eng) == "ATen op kinds on the device: not recorded"
