"""pansvr_tpu_torch — the fc_aln realignment path on PyTorch + CUDA.

A second package beside ``pansvr_tpu``: the same seed -> chain -> banded
dual-affine DP realignment, with the device stages written in PyTorch and
the two DP kernels (extd2 forward sweep and traceback) written by hand in
CUDA C++ for Hopper (``csrc/``). The NumPy/C++ host modules it needs are
its own copies of ``pansvr_tpu``'s, at the same relative paths (index
build and store, host aligner, native glue, BAM/VCF/FASTA I/O, signal
extraction, anchors, the simulator); it imports neither JAX nor
``pansvr_tpu``.

  ops/extd2.py       scoring parameters, size plan, CIGAR decode
  ops/extd2_cuda.py  extd2 forward + traceback: CUDA kernels + plain versions
  ops/seeding.py     k-mer probe, MEM extension, merge + expand
  ops/chain.py       SDP chaining + chain extraction
  ops/collect.py     device collect (select_and_paths)
  index/device.py    RdBG index -> device tensors
  align/engine.py    batched fc_aln engine (one device)
  cli/main.py        ``python -m pansvr_tpu_torch fc_aln ...``
  signal_fq.py       signal FASTQ reader + comment parser
  world.py           the benchmark worlds chip_smoke.py runs
"""

__version__ = "0.1.0"
