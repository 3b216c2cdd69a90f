"""Command line of the PyTorch/CUDA port, with the JAX package's
subcommands (pansvr_tpu/cli/main.py; the reference's surface,
src/main.cpp:47-80): fc_anchor_ref, fc_index, fc_signal, fc_aln, fc_sv,
assembly_test, sv_calling, tools, plus `run` (the panSVR_run.sh
equivalent driving all stages).

    python -m pansvr_tpu_torch <command> [options]

Same positionals and flags as ``python -m pansvr_tpu``, plus --device on
fc_aln, fc_sv and run: where the realignment engine and the contig DP
run (default cuda; asking for cuda where there is none raises, the plain
CPU path takes an explicit --device cpu). Their output files are the
JAX package's, byte for byte.

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
import time


def _fl_arg(v: str):
    """--first-level: an int, or 'auto' (size the 4^fl bucket table to
    the k-mer population; see index.builder.resolve_first_level)."""
    return v if v == "auto" else int(v)


def _cmd_fc_anchor_ref(args):
    from ..anchor.builder import AnchorConfig, run_anchor_ref
    from ..io.fasta import Faidx

    cfg = AnchorConfig(
        edge_len=args.edge_len, min_sv_len=args.min_sv_len,
        sv_type=args.sv_type, discard_decoy=args.discard_decoy,
    )
    run_anchor_ref(args.vcf, Faidx(args.ref), sys.stdout, cfg)


def _cmd_fc_index(args):
    from ..index.builder import build_index
    from ..index.store import save_index
    from ..io.fasta import read_fasta

    idx = build_index(
        list(read_fasta(args.anchors_fa).items()),
        first_level_bases=args.first_level,
    )
    save_index(idx, args.index_dir)
    print(
        f"index: {len(idx.chr_names)} contigs, {idx.n_kmers} kmers, "
        f"{idx.n_unitigs} unitigs -> {args.index_dir}", file=sys.stderr,
    )


def _cmd_fc_signal(args):
    from ..signal.extract import SignalOptions, extract_signal

    opts = SignalOptions(
        discard_both_full_match=args.discard_full_match,
        not_using_filter=args.not_use_filter,
    )
    ref = None
    if args.ref:
        from ..io.fasta import Faidx
        ref = Faidx(args.ref)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    stats = extract_signal(args.bam, out, opts=opts, ref=ref)
    if args.status_file:
        with open(args.status_file, "w") as fh:
            fh.write(stats.status_file_text())


def run_fc_aln(args, config=None, mesh=None, tracer=None):
    """signal FASTQ + index -> realigned BAM; returns the engine (its
    .prof holds the phase timers and counts, "stream_s" the wall of the
    stream after the engine is built). `config`: an
    align.engine.EngineConfig (default: its defaults); `mesh`: a data
    mesh (parallel.mesh.make_data_mesh) for the engine, which then
    ignores args.device; `tracer`: a context (a torch.profiler.profile)
    entered around the stream only, after the engine is built and the
    index is on the device; with args.trace (a directory) the profile,
    the caller's or one of the CPU and the card made here, goes to
    args.trace/trace.json with the engine's spans (utils.trace.export)."""
    from ..align import native_glue
    from ..align.bam_out import EmitContext, min_filter_score
    from ..align.engine import AlignEngine
    from ..align.host_align import PEScorer
    from ..index.store import load_any
    from ..io.bam import BamHeader, BamWriter
    from ..signal.extract import SignalStats
    from ..pipeline import parse_signal_comment, read_signal_fastq

    idx = load_any(args.index_dir)
    header = BamHeader.from_sam_text(open(args.header_sam).read())
    stats = SignalStats.parse_status_text(open(args.status_file).read()) \
        if args.status_file else SignalStats(read_len=150, min_isize=200,
                                             max_isize=600)
    eng = AlignEngine(idx, config=config, ori_chrom_names=header.ref_names,
                      device=args.device, mesh=mesh)
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
    # channel needs Python states or PANSVR_NO_NATIVE_EMIT is set
    if (ori_writer is None and not os.environ.get("PANSVR_NO_NATIVE_EMIT")
            and native_glue.emit_available()):
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

    if tracer is None and args.trace:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if eng.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        tracer = torch.profiler.profile(activities=acts)
    if tracer is None:
        tracer = contextlib.nullcontext()
    with tracer as prof:
        t = time.perf_counter()
        _run_aln_stream(chunks_a, eng, pe, writer, ori_writer, header, filt,
                        batch_stream)
        if eng.device.type == "cuda":
            import torch

            torch.cuda.synchronize(eng.device)
        eng.prof["stream_s"] = time.perf_counter() - t
    if tune_path:
        try:
            eng.save_tuning(tune_path)
        except OSError:
            pass
    if args.trace:
        from ..utils.trace import export

        os.makedirs(args.trace, exist_ok=True)
        got = export(prof, eng.tr, os.path.join(args.trace, "trace.json"))
        p = eng.prof
        phases = {k: round(v, 3) for k, v in p.items()}
        print(f"[fc_aln] engine phases (s) and counts: {phases}",
              file=sys.stderr)
        # shares of the stream (the engine build's span came before it)
        pct = {k: f"{100 * v / (p['stream_s'] or 1.0):.1f}%" for k, v in (
            ("spans", p["main_traced_s"] - p["engine_build"]),
            ("source", p["source_s"]), ("pin", p["pin_s"]),
            ("emit", p["emit_s"]), ("bam_write", p["bam_write_s"]))}
        print(f"[fc_aln] stream {p['stream_s']:.3f} s: main thread under "
              f"spans {pct['spans']}, source {pct['source']}, pin "
              f"{pct['pin']} ({int(p['n_pin'])} buffers), emit "
              f"{pct['emit']}, BAM write {pct['bam_write']}; prep worker "
              f"wall {p['prep_s']:.3f} s, CPU {p['prep_cpu_s']:.3f} s; "
              f"trace.json: {got['ranges']} pansvr ranges with batch ids, "
              f"{got['worker_spans']} worker spans (clock offset "
              f"{got['offset_us']} us)", file=sys.stderr)
        for line in _memory_lines(eng):
            print(f"[fc_aln] {line}", file=sys.stderr)
    return eng


def _memory_lines(eng) -> list[str]:
    """The engine's resident-set snapshots (AlignEngine._mem_snapshot),
    the pinned host allocator's counters and the graph warm-ups' growth,
    as lines of the phase print."""
    from ..utils.memory import KINDS

    p, mem = eng.prof, eng.mem
    pts = [k for k in ("start", "built", "end") if k in mem]
    if not pts:
        return []

    def row(val, fmt=".3f"):
        return " / ".join(format(val(pt), fmt) for pt in pts)

    kinds = ", ".join(
        f"{k} " + row(lambda pt, k=k: p[f"rss_{pt}_{k}_gib"]) for k in KINDS)
    out = [f"resident set (GiB) at engine {' / '.join(pts)}: VmRSS "
           f"{row(lambda pt: mem[pt]['vmrss'] or 0.0)} (peak "
           f"{p['rss_peak_gib']:.3f}); {kinds}; smaps read in "
           f"{row(lambda pt: mem[pt]['s'], '.4f')} s"]
    if "end" in mem:
        out.append("libraries resident at the stream's end (GiB): "
                   + ", ".join(f"{os.path.basename(path)} {g:.3f}"
                               for path, g in mem["end"]["top"]))
    if "pinned_host_gib" in p:
        peak = p.get("pinned_active_peak_gib")
        out.append(f"pinned host allocator: {p['pinned_host_gib']:.3f} GiB "
                   f"owned in {int(p.get('n_pinned_blocks', 0))} blocks, "
                   "active peak " + ("not counted by this torch"
                                     if peak is None else f"{peak:.3f} GiB"))
    out.append(f"VmRSS growth across the graph warm-ups "
               f"{p['warmup_rss_gib']:.3f} GiB, across the captures "
               f"{p['capture_rss_gib']:.3f} GiB "
               f"({int(p['n_graph_capture'])} captures)")
    return out


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
        # the BGZF compression runs inline here, every 8 MB of records
        span = eng.tr.span
        for blob in eng.align_stream(batch_stream()):
            with span("bam_write", "bam_write_s", batch=eng.last_batch,
                      bytes=len(blob)):
                writer.write_blob(blob)
        with span("bam_write", "bam_write_s", close=1):
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


def fc_sv_inputs(args):
    """(SVRefSequence, SvCallOptions) of an fc_sv command line."""
    from ..assembly.sv_call import SVRefSequence, SvCallOptions
    from ..io.bam import BamReader
    from ..io.fasta import Faidx, read_fasta
    from ..signal.extract import SignalStats

    anchors = read_fasta(args.anchors_fa)
    with BamReader(args.bam) as rd:
        ori_names = list(rd.header.ref_names)
    stats = SignalStats.parse_status_text(open(args.status_file).read()) \
        if args.status_file else SignalStats(read_len=150, ave_read_depth=30.0)
    sf = SVRefSequence(list(anchors.keys()), anchors, Faidx(args.ref), ori_names)
    opts = SvCallOptions(
        edge_len=args.edge_len,
        normal_read_len=stats.read_len or 150,
        ave_read_depth=max(stats.ave_read_depth, 1.0),
        st_chr=args.st_chr, ed_chr=args.ed_chr,
        print_detail=args.print_detail, depth_detail=args.depth_detail,
    )
    return sf, opts


def write_sv_vcf(path: str, records) -> None:
    """fc_sv's VCF of `records` at path ("-": standard output)."""
    out = open(path, "w") if path != "-" else sys.stdout
    out.write("##fileformat=VCFv4.2\n##source=pansvr_tpu\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample\n")
    for rec in records:
        out.write(rec.to_line() + "\n")
    if out is not sys.stdout:
        out.close()


def run_fc_sv(args):
    """realigned BAM -> VCF; returns (verdicts, the ContigDpBatcher, whose
    .prof holds the DP's counts and phase seconds)."""
    from ..assembly.sv_call import ContigDpBatcher, run_sv_calling

    dp = ContigDpBatcher(device=args.device)
    verdicts, records = run_sv_calling(args.bam, *fc_sv_inputs(args), dp=dp)
    write_sv_vcf(args.output, records)
    n_pass = sum(1 for v in verdicts if v.passed)
    print(f"{n_pass}/{len(verdicts)} SV regions PASS", file=sys.stderr)
    return verdicts, dp


def _cmd_run(args):
    from ..pipeline import PipelineConfig, run_pipeline

    out = run_pipeline(args.vcf, args.ref, args.bam, args.workdir,
                       PipelineConfig(first_level_bases=args.first_level,
                                      sv_shards=args.sv_shards),
                       device=args.device)
    print(out)


def _cmd_assembly_test(args):
    from ..assembly.assembler import AssemblyManager

    am = AssemblyManager()
    for line in sys.stdin:
        seq = line.strip()
        if seq:
            am.add_read(seq)
    for c in am.assemble():
        print(
            f"CONTIG size: [{len(c.seq)}] seedCount: [{c.seed_read_count}] "
            f"supportReads: [{len(c.support_reads)}] "
            f"ending_reason: [{c.ending_reason[0]} {c.ending_reason[1]}]"
        )
        print(c.seq)


def _cmd_sv_calling(args):
    from ..assembly.denovo import DeNovoCaller, DeNovoOptions
    from ..io.fasta import Faidx

    caller = DeNovoCaller(
        Faidx(args.ref),
        DeNovoOptions(min_support=args.min_support),
    )
    records = caller.call_bam(args.bam)
    out = open(args.output, "w") if args.output != "-" else sys.stdout
    out.write("##fileformat=VCFv4.2\n##source=pansvr_tpu-denovo\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample\n")
    for rec in records:
        out.write(rec.to_line() + "\n")
    if out is not sys.stdout:
        out.close()
    print(f"{len(records)} de novo SV calls", file=sys.stderr)


def _cmd_tools(args):
    from . import tools

    tools.dispatch(args.tool, args.tool_args)


def _device_arg(s, what):
    s.add_argument("--device", default="cuda",
                   help=f"torch device of {what}: cuda (default; raises "
                        "when absent) or cpu (plain PyTorch kernels)")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="pansvr_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("fc_anchor_ref", help="VCF+ref -> anchor FASTA (stdout)")
    s.add_argument("ref")
    s.add_argument("vcf")
    s.add_argument("-e", "--edge-len", type=int, default=500)
    s.add_argument("-m", "--min-sv-len", type=int, default=50)
    s.add_argument("-T", "--sv-type", default="ALL")
    s.add_argument("-J", "--discard-decoy", action="store_true")
    s.set_defaults(fn=_cmd_fc_anchor_ref)

    s = sub.add_parser("fc_index", help="anchor FASTA -> RdBG index dir")
    s.add_argument("anchors_fa")
    s.add_argument("index_dir")
    s.add_argument("--first-level", type=_fl_arg, default="auto")
    s.set_defaults(fn=_cmd_fc_index)

    s = sub.add_parser("fc_signal", help="BAM/CRAM -> signal FASTQ")
    s.add_argument("bam")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-s", "--status-file", default="status.txt")
    s.add_argument("-U", "--discard-full-match", action="store_true")
    s.add_argument("-D", "--not-use-filter", action="store_true")
    s.add_argument("-f", "--ref", default=None,
                   help="reference FASTA (required for CRAM input)")
    s.set_defaults(fn=_cmd_fc_signal)

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
    _device_arg(s, "the realignment engine")
    s.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace of the "
                        "realignment stream to DIR/trace.json: the card's "
                        "kernels and copies, the main thread's pansvr.* "
                        "phase ranges (never nested, each with its batch "
                        "id) and the prep worker's spans on a track of "
                        "their own, on one timeline; print the engine "
                        "phase timers, the main thread's share under "
                        "spans and the source, pin, emit and BAM write "
                        "shares, and the prep worker's wall and CPU")
    s.set_defaults(fn=run_fc_aln)

    s = sub.add_parser("fc_sv", help="realigned BAM -> VCF")
    s.add_argument("anchors_fa")
    s.add_argument("bam")
    s.add_argument("ref")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-r", "--status-file", default=None)
    s.add_argument("-e", "--edge-len", type=int, default=500)
    s.add_argument("-S", "--st-chr", type=int, default=0)
    s.add_argument("-E", "--ed-chr", type=int, default=10000)
    s.add_argument("-D", "--print-detail", action="store_true",
                   help="per-read pileup renderings to stderr")
    s.add_argument("-d", "--depth-detail", action="store_true",
                   help="event-matrix dumps to stderr")
    _device_arg(s, "the contig DP")
    s.set_defaults(fn=run_fc_sv)

    s = sub.add_parser("run", help="full pipeline (panSVR_run.sh equivalent)")
    s.add_argument("ref")
    s.add_argument("vcf")
    s.add_argument("bam")
    s.add_argument("workdir")
    s.add_argument("--first-level", type=_fl_arg, default="auto")
    s.add_argument("--sv-shards", type=int, default=1,
                   help="fan fc_sv out over N worker processes "
                        "(panSVR_run.sh per-chromosome fan-out analog)")
    _device_arg(s, "the realignment engine and the contig DP")
    s.set_defaults(fn=_cmd_run)

    s = sub.add_parser("assembly_test", help="assemble reads from stdin")
    s.set_defaults(fn=_cmd_assembly_test)

    s = sub.add_parser("sv_calling", help="de novo SV caller (NovaSV analog)")
    s.add_argument("ref")
    s.add_argument("bam")
    s.add_argument("-o", "--output", default="-")
    s.add_argument("-m", "--min-support", type=int, default=3)
    s.set_defaults(fn=_cmd_sv_calling)

    s = sub.add_parser("tools", help="analysis toolbox")
    s.add_argument("tool")
    s.add_argument("tool_args", nargs="*")
    s.set_defaults(fn=_cmd_tools)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
