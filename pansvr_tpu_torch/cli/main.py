"""Command line of the PyTorch/CUDA port: the fc_aln stage.

    python -m pansvr_tpu_torch fc_aln INDEX_DIR SIGNAL_FQ HEADER_SAM \\
        [-o output.bam] [-p ori.bam] [-r status.txt] [-b 2048] \\
        [--device cuda|cpu] [--trace DIR]

Same positionals and flags as ``python -m pansvr_tpu fc_aln``, plus
--device (default cuda; asking for cuda where there is none raises, the
plain CPU path takes an explicit --device cpu). The other subcommands
live in ``python -m pansvr_tpu``.

Like the JAX CLI, fc_aln starts the engine from INDEX_DIR/engine_tune.json
(the lane budgets a previous run on that index converged to; either
package's file loads in the other) and writes it back at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import sys

OTHER_COMMANDS = ("fc_anchor_ref", "fc_index", "fc_signal", "fc_sv", "run",
                  "assembly_test", "sv_calling", "tools")


def run_fc_aln(args, config=None):
    """signal FASTQ + index -> realigned BAM; returns the engine (its
    .prof holds the phase timers and counts). `config`: an
    align.engine.EngineConfig (default: its defaults)."""
    from ..align import native_glue
    from ..align.bam_out import EmitContext, min_filter_score
    from ..align.engine import AlignEngine
    from ..align.host_align import PEScorer
    from ..index.store import load_any
    from ..io.bam import BamHeader, BamWriter
    from ..signal.extract import SignalStats
    from ..signal_fq import parse_signal_comment, read_signal_fastq

    idx = load_any(args.index_dir)
    header = BamHeader.from_sam_text(open(args.header_sam).read())
    stats = SignalStats.parse_status_text(open(args.status_file).read()) \
        if args.status_file else SignalStats(read_len=150, min_isize=200,
                                             max_isize=600)
    eng = AlignEngine(idx, config=config, ori_chrom_names=header.ref_names,
                      device=args.device)
    tune_path = os.path.join(args.index_dir, "engine_tune.json") \
        if os.path.isdir(args.index_dir) else None
    if tune_path and eng.load_tuning(tune_path):
        print(f"[fc_aln] engine tuning loaded from {tune_path}",
              file=sys.stderr)
    pe = PEScorer(eng.host, stats.max_isize or 600, stats.min_isize or 200,
                  stats.read_len or 150)
    writer = BamWriter(args.output, header)
    ori_writer = BamWriter(args.output_ori, header) if args.output_ori \
        else None
    filt = min_filter_score(stats.read_len or 150)
    step = 2 * (args.batch // 2)

    def chunk_stream():
        """Engine-batch chunks of the signal FASTQ; a trailing unpaired
        record is dropped like the reference's paired loop."""
        buf = []
        for rec in read_signal_fastq(args.signal_fq):
            buf.append(rec)
            if len(buf) == step:
                yield buf
                buf = []
        if len(buf) >= 2:
            yield buf[: len(buf) // 2 * 2]

    # native emit (PE pairing + BAM encoding in C++) unless the -p side
    # channel needs Python states
    if ori_writer is None and native_glue.emit_available():
        eng.set_native_emit(EmitContext(
            eng.host, header, stats.max_isize or 600,
            stats.min_isize or 200, stats.read_len or 150))
        chunks_a = iter(())

        def batch_stream():
            for chunk in chunk_stream():
                comments = [p[3] for p in chunk]
                oris = native_glue.parse_comments(comments)
                if oris is None:
                    oris = [parse_signal_comment(c)[0] for c in comments]
                yield ([p[1] for p in chunk], oris,
                       ([p[0] for p in chunk], [p[2] for p in chunk],
                        comments))
    else:
        chunks_a, chunks_b = itertools.tee(chunk_stream())

        def batch_stream():
            for chunk in chunks_b:
                yield ([p[1] for p in chunk],
                       [parse_signal_comment(p[3])[0] for p in chunk])

    tracer = contextlib.nullcontext()
    if args.trace:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        tracer = torch.profiler.profile(activities=acts)
    with tracer as prof:
        _run_aln_stream(chunks_a, eng, pe, writer, ori_writer, header, filt,
                        batch_stream)
    if tune_path:
        try:
            eng.save_tuning(tune_path)
        except OSError:
            pass
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
        phases = {k: round(v, 3) for k, v in eng.prof.items()}
        print(f"[fc_aln] engine phases (s) and counts: {phases}",
              file=sys.stderr)
    return eng


def _run_aln_stream(chunks_a, eng, pe, writer, ori_writer, header, filt,
                    batch_stream):
    """Consume align_stream batches, PE-score and write BAM records.

    Emission runs on a single writer thread pipelined one batch behind
    the engine (the reference's kt_pipeline step2 analog,
    read_realignment.cpp:165-176): the Python emit work overlaps the
    engine's GIL-released device waits, and single-thread writes keep
    BAM record order deterministic.

    With native emit enabled on the engine, align_stream yields encoded
    record blobs straight from C++ (byte-identical to this path,
    tests/test_native_emit.py) and only the BGZF write remains here."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..align.bam_out import emit_ori_pair, emit_pair

    if getattr(eng, "_emit_ctx", None) is not None and ori_writer is None:
        for blob in eng.align_stream(batch_stream()):
            writer.write_blob(blob)
        writer.close()
        return

    def emit_chunk(chunk, states):
        for k in range(0, len(chunk) - 1, 2):
            pr = pe.pair(states[k], states[k + 1])
            if ori_writer is not None:
                for rec in emit_ori_pair(
                    pr, states[k], states[k + 1],
                    chunk[k][0], chunk[k][1], chunk[k][2],
                    chunk[k + 1][1], chunk[k + 1][2],
                    chunk[k][3], chunk[k + 1][3], header, filt,
                    header.ref_names,
                ):
                    ori_writer.write(rec)
            if not pr.gain_better:
                continue
            for rec in emit_pair(
                eng.host, pr, states[k], states[k + 1],
                chunk[k][0], chunk[k][1], chunk[k][2],
                chunk[k + 1][1], chunk[k + 1][2],
                chunk[k][3], chunk[k + 1][3], header,
            ):
                writer.write(rec)

    pool = ThreadPoolExecutor(1)
    futs: deque = deque()
    try:
        for chunk, states in zip(chunks_a, eng.align_stream(batch_stream())):
            futs.append(pool.submit(emit_chunk, chunk, states))
            while len(futs) > 2:
                futs.popleft().result()
        while futs:
            futs.popleft().result()
    finally:
        pool.shutdown(wait=True)
    writer.close()
    if ori_writer is not None:
        ori_writer.close()


def parse_args(argv):
    p = argparse.ArgumentParser(prog="pansvr_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("fc_aln", help="signal FASTQ -> realigned BAM")
    s.add_argument("index_dir")
    s.add_argument("signal_fq")
    s.add_argument("header_sam")
    s.add_argument("-o", "--output", default="output.bam")
    s.add_argument("-p", "--output-ori", default=None,
                   help="side-channel BAM of ORIGINAL alignments for pairs "
                        "neither reference explains")
    s.add_argument("-r", "--status-file", default=None)
    s.add_argument("-b", "--batch", type=int, default=2048)
    s.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises when absent) "
                        "or cpu (plain PyTorch kernels)")
    s.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace of the "
                        "realignment stream to DIR/trace.json and print "
                        "the engine phase timers")
    return p.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in OTHER_COMMANDS:
        print(f"pansvr_tpu_torch ports fc_aln only; run `python -m "
              f"pansvr_tpu {argv[0]} ...` for {argv[0]}", file=sys.stderr)
        return 2
    run_fc_aln(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
