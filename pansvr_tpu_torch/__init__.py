"""pansvr_tpu_torch — pansvr_tpu's pipeline on PyTorch + CUDA.

A second package beside ``pansvr_tpu``: the same stages (anchor
reference, RdBG index, signal extraction, seed -> chain -> banded
dual-affine DP realignment, per-SV assembly and VCF, the de novo caller
and the toolbox), with the device stages written in PyTorch and, for a
card, by hand in CUDA C++ for Hopper (``csrc/``): the two DP kernels
(extd2 forward sweep and traceback), which the realigner and fc_sv's
contig DP launch, and the realigner's front, chain, collect and DP glue. The NumPy/C++ host modules are its own copies of ``pansvr_tpu``'s,
at the same relative paths; it imports neither JAX nor ``pansvr_tpu``.

  ops/extd2.py          scoring parameters, size plan, CIGAR decode
  ops/extd2_cuda.py     extd2 forward + traceback: CUDA kernels + plain versions
  ops/onchip_check.py   the kernels vs the scalar oracle on a device
  ops/seeding.py        k-mer probe, MEM extension, merge + expand
  ops/chain.py          SDP chaining + chain extraction
  ops/collect.py        device collect (select_and_paths)
  ops/front_cuda.py     front, chain, collect, DP glue: the card's kernels
  index/device.py       RdBG index -> device tensors
  align/engine.py       batched fc_aln engine (one device)
  assembly/sv_call.py   fc_sv: assembly, ContigDpBatcher, verdicts
  assembly/denovo.py    the de novo caller (sv_calling)
  pipeline.py           `run`: every stage; signal FASTQ helpers
  parallel/fanout.py    fc_sv over worker processes
  cli/main.py           ``python -m pansvr_tpu_torch <command> ...``
  world.py              the benchmark worlds chip_smoke.py runs
"""

__version__ = "0.1.0"
