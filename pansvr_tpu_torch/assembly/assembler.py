"""Iterative greedy de Bruijn assembler (Manta-style word ladder).

Clean-room implementation of the behavioral contract documented in
SURVEY.md §8.1 (after src/cpp_lib/Assembler/mantaAssembler.{hpp,cpp}, an
Illumina Manta derivation): word lengths 26..126 step 10 with pseudo-read
re-injection, greedy bidirectional contig walks with per-branch allele
read bookkeeping, Tarjan small-circle repeat detection, and greedy
set-cover contig selection. Every support add/remove is journaled as an
action (kmer_index, read_id, is_add) — downstream position voting
(fc_sv) replays this journal.

The port's copy of pansvr_tpu/assembly/assembler.py: each word-length
pass runs in the native glue library (required); the original's Python
word ladder, which it falls back to when the library lacks the pass, is
not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field

@dataclass
class AssemblerOptions:
    alphabet: str = "ACGT"
    min_word_length: int = 26
    max_word_length: int = 126
    max_word_length_without_enough_read: int = 126
    word_step: int = 10
    min_contig_length: int = 45
    min_coverage: int = 2
    min_conservative_coverage: int = 2
    min_unused_reads: int = 3
    min_support_reads: int = 3
    max_assembly_count: int = 10
    reject_read_reused: bool = False


@dataclass
class AssembledContig:
    seq: str = ""
    support_reads: set = field(default_factory=set)
    reject_reads: set = field(default_factory=set)
    seed_read_count: int = 0
    word_length: int = 0
    # journal of support changes: (kmer_index_in_contig, read_id, is_add)
    actions: list = field(default_factory=list)
    ass_begin_offset_in_contig: int = 0  # final leftward extension count (<=0)
    conservative_range_bgn: int = 0
    conservative_range_end: int = 0
    ending_reason: list = field(default_factory=lambda: [-1, -1])
    new_support_read: int = 0


class AssemblyManager:
    def __init__(self, options: AssemblerOptions | None = None):
        self.o = options or AssemblerOptions()
        self.reads: list[str] = []
        self.read_is_pseudo: list[bool] = []
        self.contigs: list[AssembledContig] = []
        self._tmp_contigs: list[AssembledContig] = []

    def clear(self):
        self.reads = []
        self.read_is_pseudo = []
        self.contigs = []

    def add_read(self, seq: str):
        self.reads.append(seq)

    def set_repeat_mode(self):
        self.o.reject_read_reused = True
        self.o.max_assembly_count = 5

    def set_normal_mode(self):
        self.o.reject_read_reused = False
        self.o.max_assembly_count = 10

    # ------------------------------------------------------------------
    def _build_contigs(self, wl: int):
        """One word-length pass in C++ (native_glue.asm_build_contigs),
        bit-identical contigs and journals to the original's Python word
        ladder (tests/test_assembler_native.py, and the port's assembler
        against the original in tests/test_torch_sv.py). The native glue
        library is required: a library without the pass raises."""
        from ..align import native_glue

        res = native_glue.asm_build_contigs(
            native_glue.get_lib(), self.reads, self.read_is_pseudo, wl,
            self.o.min_coverage, self.o.min_conservative_coverage,
            self.o.max_assembly_count, self.o.reject_read_reused,
        )
        if res is None:
            raise RuntimeError("the native engine glue library has no "
                               "glue_asm_run (rebuild it with "
                               "tools/build_native.sh)")
        success, gmax, raw = res
        self._tmp_contigs = []
        for r in raw:
            m = r["meta"]
            self._tmp_contigs.append(AssembledContig(
                seq=r["seq"],
                support_reads=set(int(x) for x in r["support"]),
                reject_reads=set(int(x) for x in r["reject"]),
                actions=r["actions"],
                seed_read_count=int(m[0]), word_length=int(m[1]),
                ass_begin_offset_in_contig=int(m[2]),
                conservative_range_bgn=int(m[3]),
                conservative_range_end=int(m[4]),
                ending_reason=[int(m[5]), int(m[6])],
            ))
        return success, gmax

    def _select_contigs(self, normal_read_count: int):
        o = self.o
        self.contigs = []
        used_reads: set = set()
        used_pseudo: set = set()
        tmp = self._tmp_contigs
        while tmp and len(self.contigs) < o.max_assembly_count:
            used_normal = len(used_reads) - len(used_pseudo)
            if normal_read_count - used_normal < o.min_unused_reads:
                return
            to_remove = set()
            selected = None
            selected_idx = -1
            max_support = 0
            max_length = 0
            for ci, contig in enumerate(tmp):
                new_support = contig.support_reads - used_reads
                new_normal = sum(
                    1 for rd in new_support if not self._is_pseudo(rd)
                )
                if self.contigs and new_normal < o.min_support_reads:
                    to_remove.add(ci)
                    continue
                better = len(new_support) > max_support or (
                    len(new_support) == max_support and len(contig.seq) > max_length
                )
                if better:
                    selected = contig
                    selected.new_support_read = new_normal
                    selected_idx = ci
                    max_support = len(new_support)
                    max_length = len(contig.seq)
            if max_support == 0:
                break
            self.contigs.append(selected)
            to_remove.add(selected_idx)
            self._tmp_contigs = [
                c for ci, c in enumerate(tmp) if ci not in to_remove
            ]
            tmp = self._tmp_contigs
            for rd in selected.support_reads:
                used_reads.add(rd)
                if self._is_pseudo(rd):
                    used_pseudo.add(rd)

    def _is_pseudo(self, rd: int) -> bool:
        """Support indices can outlive the pseudo-read truncation of the
        final failed word-length iteration (the reference indexes
        readInfo out of range in exactly this state — selectContigs,
        mantaAssembler.cpp:583-588 after the erase at :654-661, which is
        UB in C++). Every such stale index referred to a pseudo read, so
        count it as one."""
        return rd >= len(self.read_is_pseudo) or self.read_is_pseudo[rd]

    # ------------------------------------------------------------------
    def assemble(self) -> list[AssembledContig]:
        o = self.o
        normal_read_count = len(self.reads)
        self.read_is_pseudo = [False] * normal_read_count
        global_max_count = 0
        wl = o.min_word_length
        while wl <= o.max_word_length and not (
            global_max_count < 100 and wl > o.max_word_length_without_enough_read
        ):
            success, global_max_count = self._build_contigs(wl)
            if success:
                break
            # drop pseudo reads from the previous iteration
            for ridx in range(len(self.reads)):
                if self.read_is_pseudo[ridx]:
                    self.reads = self.reads[:ridx]
                    self.read_is_pseudo = self.read_is_pseudo[:ridx]
                    break
            # re-inject long contigs as pseudo reads
            for contig in self._tmp_contigs:
                if len(contig.seq) > wl + o.word_step:
                    self.reads.append(contig.seq)
                    self.read_is_pseudo.append(True)
            wl += o.word_step
        self._select_contigs(normal_read_count)
        return self.contigs
