"""Command-line interface of the port (reference: main.go, cmd/filter.go,
cmd/convert.go; the JAX package's elprep_tpu/cli.py).

Subcommands: ``filter``, ``split``, ``merge``, ``sfm``,
``merge-optical-duplicates-metrics``, ``vcf-to-elsites``,
``bed-to-elsites`` and ``fasta-to-elfasta``. ``filter`` runs the
in-memory 5-step pipeline (parse -> filters + duplicate marking -> sort
-> optical duplicates -> BQSR -> write -> HaplotypeCaller) and the
constant-memory streaming path; a directory input merges the files in
it. With the HaplotypeCaller, or with BQSR on the CPU, it starts the
worker pool (hc/parallel.py) before the read phase. ``--sharded`` runs the
duplicate marking, sort and BQSR table build over the device mesh and the
PairHMM over the same mesh (parallel/); in a process group
(``python -m elprep_tpu_torch.parallel.multihost``) the HaplotypeCaller is
also partitioned by contig across the processes.

The compute device is ``cuda`` unless ``ELPREP_TPU_TORCH_DEVICE`` names
another (``cpu``). Asking for ``cuda`` without a card fails before any
work starts.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import device as _device
from . import trace

_PHASE = [0]
# the ids of this process's --timed jobs in the span recorder
_JOBS = itertools.count(1)


def _timed(enabled: bool, msg: str, fn, profile: str, span: str):
    """(reference: timedRun, cmd/util.go:262-281). With ``enabled`` (a
    ``--timed`` job, whose recorder is on) the phase is the span ``span``
    and its seconds are the span's."""
    _PHASE[0] += 1
    if profile:
        import cProfile

        pr = cProfile.Profile()
        pr.enable()
    if enabled:
        print(msg, file=sys.stderr)
        with trace.span(span) as sp:
            out = fn()
        print(f"  done in {sp.seconds:.2f}s", file=sys.stderr)
    else:
        out = fn()
    if profile:
        pr.disable()
        pr.dump_stats(f"{profile}{_PHASE[0]}.prof")
    return out


def _setup_log(log_path: str, command_line: str) -> None:
    """Tee stderr into a timestamped log file
    (reference: cmd/util.go:228-260)."""
    if not log_path:
        return
    os.makedirs(log_path, exist_ok=True)
    name = os.path.join(log_path, "elprep_tpu_torch-%s.log"
                        % time.strftime("%Y-%m-%d-%H-%M-%S"))

    class _Tee:
        def __init__(self, f1, f2):
            self.f1, self.f2 = f1, f2

        def write(self, s):
            self.f1.write(s)
            self.f2.write(s)

        def flush(self):
            self.f1.flush()
            self.f2.flush()
    fh = open(name, "a")
    fh.write(command_line + "\n")
    sys.stderr = _Tee(sys.stderr, fh)


def _build_filter_parser() -> argparse.ArgumentParser:
    """The JAX package's filter options, so that a command line means the
    same to both."""
    p = argparse.ArgumentParser(prog="elprep_tpu_torch filter", add_help=True)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--output-type", choices=["sam", "bam"], default="")
    p.add_argument("--filter-unmapped-reads", action="store_true")
    p.add_argument("--filter-unmapped-reads-strict", action="store_true")
    p.add_argument("--filter-mapping-quality", type=int, default=0)
    p.add_argument("--filter-non-exact-mapping-reads", action="store_true")
    p.add_argument("--filter-non-exact-mapping-reads-strict", action="store_true")
    p.add_argument("--filter-non-overlapping-reads", default="")
    p.add_argument("--clear-duplicate-flag", action="store_true")
    p.add_argument("--rename-chromosomes", action="store_true")
    p.add_argument("--clean-sam", action="store_true")
    p.add_argument("--replace-reference-sequences", default="")
    p.add_argument("--replace-read-group", default="")
    p.add_argument("--mark-duplicates", action="store_true")
    p.add_argument("--mark-optical-duplicates", default="")
    p.add_argument("--mark-optical-duplicates-intermediate", default="")
    p.add_argument("--optical-duplicates-pixel-distance", type=int, default=100)
    p.add_argument("--remove-duplicates", action="store_true")
    p.add_argument("--remove-optional-fields", default="")
    p.add_argument("--keep-optional-fields", default="")
    p.add_argument("--sorting-order", default="keep",
                   choices=["keep", "unknown", "unsorted", "queryname", "coordinate"])
    p.add_argument("--bqsr", default="")
    p.add_argument("--bqsr-tables-only", default="")
    p.add_argument("--bqsr-apply", default="")
    p.add_argument("--recal-file", default="")
    p.add_argument("--bqsr-tablename-prefix", default="GATK")
    p.add_argument("--reference", default="")
    p.add_argument("--known-sites", default="")
    p.add_argument("--quantize-levels", type=int, default=0)
    p.add_argument("--sqq", default="")
    p.add_argument("--max-cycle", type=int, default=500)
    p.add_argument("--haplotypecaller", default="")
    p.add_argument("--reference-confidence", default="GVCF",
                   choices=["GVCF", "BP_RESOLUTION", "NONE"])
    p.add_argument("--assembly-region-padding", type=int, default=100,
                   help="padding around assembly regions during variant "
                        "calling (only with --haplotypecaller)")
    p.add_argument("--sample-name", default="")
    p.add_argument("--target-regions", default="")
    p.add_argument("--spread-file", default="")
    p.add_argument("--random-seed-file", default="")
    p.add_argument("--nr-of-threads", type=int, default=0,
                   help="threads of the native host code and worker processes "
                        "of the BQSR table build (on the CPU) and the "
                        "HaplotypeCaller (default: the CPU count; "
                        "ELPREP_TPU_HC_WORKERS overrides the worker count)")
    p.add_argument("--timed", action="store_true")
    p.add_argument("--profile", default="",
                   help="write a cProfile dump per phase to PREFIX<phase>.prof")
    p.add_argument("--log-path", default="")
    p.add_argument("--activity-profile", default="")
    p.add_argument("--assembly-regions", default="")
    p.add_argument("--mark-duplicates-deterministic", action="store_true")  # compat no-op
    p.add_argument("--pg-cmd-line", default="",
                   help="program command line to be stored in the header")
    p.add_argument("--randomized-qd", action="store_true",
                   help="jitter QD >= 35 with Gaussian noise like the "
                        "reference's default build; default is the "
                        "deterministic fixed_high_qd clamp")
    p.add_argument("--pedantic", action="store_true",
                   help="binary-parity behaviors of the reference's "
                        "`pedantic` build tag")
    p.add_argument("--host-pairhmm", action="store_true",
                   help="use the f64 host PairHMM instead of the device kernel")
    p.add_argument("--sharded", action="store_true",
                   help="shard the in-memory pipeline over the device mesh: "
                        "per-shard sort+dedup, a summed BQSR table build and "
                        "the PairHMM split over the mesh (needs "
                        "--mark-duplicates and --sorting-order coordinate for "
                        "the sort, dedup and BQSR parts)")
    return p


def filter_command(argv: List[str]) -> int:
    """``filter``. With ``--timed`` the job runs under the span recorder
    (trace.py): its phases, threads and pool as spans and counters under
    the root span ``job``, then one summary line per process kind, thread
    and name on standard error."""
    args = _build_filter_parser().parse_args(argv)
    if not args.timed:
        return _filter(args, argv)
    job = next(_JOBS)
    trace.enable(job)
    try:
        with trace.span("job"):
            rc = _filter(args, argv)
    finally:
        trace.disable()
    for line in trace.summary(job):
        print(line, file=sys.stderr)
    return rc


def _filter(args, argv: List[str]) -> int:
    from .core.header import SortingOrder
    from .core.pipeline import SamData, run_pipeline
    from .io import sam as samio
    from .filters import simple as fsimple
    from .filters.markdup import MarkDuplicatesState, mark_duplicates_filter
    from .filters import optical as foptical
    from .filters import bqsr as fbqsr
    from .filters import bqsr_report
    from .io.fasta import MappedFasta, RefIndex
    from .io import bed as bedio
    from .io import intervals as iv

    command_line = "elprep_tpu_torch filter " + " ".join(argv)
    dev = _device.default_device_from_env()

    sorting_order = SortingOrder(args.sorting_order)
    if args.nr_of_threads > 0:
        # (reference: runtime.GOMAXPROCS, cmd/filter.go:906-909)
        from . import native

        native.set_default_threads(args.nr_of_threads)
    if args.pedantic:
        from . import pedantic

        pedantic.set_pedantic(True)
    want_bqsr = bool(args.bqsr or args.bqsr_tables_only)
    want_hc = bool(args.haplotypecaller)
    if (want_bqsr or args.bqsr_apply) and not args.reference:
        print("error: --reference required for BQSR", file=sys.stderr)
        return 2
    if want_hc and not args.reference:
        print("error: --reference required for --haplotypecaller", file=sys.stderr)
        return 2
    if not (want_bqsr or args.bqsr_apply):
        # (reference: checkNonBQSROptions, cmd/util.go:183-194)
        for flag_name, is_set in (("--quantize-levels", args.quantize_levels != 0),
                                  ("--sqq", bool(args.sqq)),
                                  ("--known-sites", bool(args.known_sites))):
            if is_set:
                print(f"Warning: The {flag_name} optional flag is set without "
                      "using --bqsr. This parameter is ignored because base "
                      "recalibration is not requested.", file=sys.stderr)

    # filters1 construction mirrors cmd/filter.go:691-780
    filters1: List = []
    if args.filter_unmapped_reads_strict:
        filters1.append(fsimple.remove_unmapped_reads_strict)
    elif args.filter_unmapped_reads:
        filters1.append(fsimple.remove_unmapped_reads)
    if args.filter_mapping_quality > 0:
        filters1.append(fsimple.remove_mapping_quality_less_than(args.filter_mapping_quality))
    if args.filter_non_exact_mapping_reads:
        filters1.append(fsimple.remove_non_exact_mapping_reads)
    if args.filter_non_exact_mapping_reads_strict:
        filters1.append(fsimple.remove_non_exact_mapping_reads_strict)
    if args.filter_non_overlapping_reads:
        bed = bedio.parse_bed(args.filter_non_overlapping_reads)
        filters1.append(fsimple.remove_non_overlapping_reads(bed))
    if args.clear_duplicate_flag:
        filters1.append(fsimple.clear_duplicate_flag)
    if args.rename_chromosomes:
        filters1.append(fsimple.rename_chromosomes)
    if args.clean_sam:
        filters1.append(fsimple.clean_sam)
    if args.replace_reference_sequences:
        filters1.append(fsimple.replace_reference_sequence_dictionary_from_sam_file(
            args.replace_reference_sequences))
    if args.replace_read_group:
        from .core.header import parse_header_line_from_string

        filters1.append(fsimple.add_or_replace_read_group(
            parse_header_line_from_string(args.replace_read_group)))
    if (args.replace_reference_sequences or args.mark_duplicates
            or sorting_order in (SortingOrder.COORDINATE, SortingOrder.QUERYNAME)
            or want_bqsr or args.bqsr_apply or want_hc):
        filters1.append(fsimple.add_refid)
    use_sharded = bool(args.sharded and args.mark_duplicates
                       and sorting_order == SortingOrder.COORDINATE)
    md_state = None
    if args.mark_duplicates and not use_sharded:
        md_state = MarkDuplicatesState()
        filters1.append(mark_duplicates_filter(state=md_state, device=dev))
    # in sharded mode remove_optional_reads runs after the sharded
    # dedup+sort, keeping the serial phase order
    if not use_sharded:
        filters1.append(fsimple.remove_optional_reads)

    filters2: List = []
    if args.remove_duplicates:
        filters2.append(fsimple.remove_duplicate_reads)
    if args.remove_optional_fields:
        if args.remove_optional_fields == "all":
            # "all" removes everything = keep the empty set
            # (reference: cmd/filter.go:879-880 KeepOptionalFields(nil))
            filters2.append(fsimple.keep_optional_fields([]))
        else:
            tags = [t.strip() for t in args.remove_optional_fields.split(",")]
            filters2.append(fsimple.remove_optional_fields(tags))
    if args.keep_optional_fields:
        if args.keep_optional_fields == "none":
            filters2.append(fsimple.keep_optional_fields([]))
        else:
            tags = [t.strip() for t in args.keep_optional_fields.split(",")]
            filters2.append(fsimple.keep_optional_fields(tags))
    # the @PG record names the program as the JAX package does, so the
    # two packages' outputs agree record for record
    filters1.insert(0, fsimple.add_pg_line({
        "ID": "elprep_tpu", "PN": "elprep_tpu", "VN": "5.1.3",
        "CL": args.pg_cmd_line or command_line,
    }))
    from .hc.genotyping import set_randomized_qd

    set_randomized_qd(args.randomized_qd)

    bed_obj = None
    bed_regions = None
    if args.target_regions:
        bed_obj = bedio.parse_bed(args.target_regions)
        bed_regions = iv.from_bed(bed_obj)
        for c in list(bed_regions):
            bed_regions[c] = iv.flatten(iv.sort_by_start(bed_regions[c]))

    # Streaming path (reference: runBestPracticesPipeline,
    # cmd/filter.go:328-341): no sort/dedup/BQSR/HC -> constant memory
    if (sorting_order in (SortingOrder.KEEP, SortingOrder.UNKNOWN, SortingOrder.UNSORTED)
            and not args.mark_duplicates and not want_bqsr and not args.bqsr_apply
            and not want_hc and not args.spread_file and not os.path.isdir(args.input)
            and args.output not in ("/dev/null", "/dev/zero")):
        _timed(args.timed, "Running pipeline.",
               lambda: _streaming_phase(args, filters1 + filters2, sorting_order),
               args.profile, "phase.stream")
        return 0

    def read_phase():
        if os.path.isdir(args.input):
            # a directory input merges all contained files
            # (reference: sam/merge-inputs.go)
            from .io.merge_inputs import read_and_merge_files

            with trace.span("read.parse"):
                hdr, batch = read_and_merge_files(sorted(
                    os.path.join(args.input, f) for f in os.listdir(args.input)
                    if not f.startswith(".")))
        else:
            with trace.span("read.parse"):
                hdr, batch = samio.read_sam_file(args.input)
        if use_sharded:
            from .core.pipeline import effective_sorting_order
            from .parallel.mesh import make_mesh
            from .parallel.sharded import run_sharded_sort_dedup

            data0 = run_pipeline(SamData(hdr, batch), filters1, SortingOrder.KEEP,
                                 device=dev)
            so = effective_sorting_order(sorting_order, data0.header, hdr.hd_so())
            batch2, _ = run_sharded_sort_dedup(
                data0.batch, data0.header, make_mesh(device=dev),
                do_sort=so == SortingOrder.COORDINATE)
            return run_pipeline(SamData(data0.header, batch2),
                                [fsimple.remove_optional_reads], SortingOrder.KEEP,
                                device=dev)
        return run_pipeline(SamData(hdr, batch), filters1, sorting_order, device=dev,
                            spans=("read.dedup", "read.sort"))

    _setup_log(args.log_path, command_line)
    pool = None
    if want_hc or (want_bqsr and dev.type == "cpu" and not use_sharded):
        # spawn the worker pool now: the workers' imports overlap the
        # read phase instead of stalling its first use. On cuda (and in
        # sharded mode) the BQSR table build stays on the mesh, so only
        # the HC uses the pool.
        from .hc.parallel import get_pool

        pool = get_pool(_nr_workers(args))
    data = _timed(args.timed, "Reading SAM into memory and applying filters.",
                  read_phase, args.profile, "phase.read")

    # Phase 2: optical duplicates — host numpy over a snapshot of the
    # post-dedup batch, independent of BQSR, so when a table build
    # follows it runs in a thread beside it. It touches no CUDA state:
    # the card is driven from this thread only.
    optical_future = None
    if args.mark_optical_duplicates or args.mark_optical_duplicates_intermediate:
        def optical_phase(ob=data.batch, oh=data.header):
            from .filters.markdup import aux_from_temps

            aux = aux_from_temps(ob) or (md_state.aux if md_state else None)
            ctrs = foptical.mark_optical_duplicates(
                ob, oh, aux,
                pixel_distance=args.optical_duplicates_pixel_distance)
            if args.mark_optical_duplicates:
                foptical.print_duplicates_metrics(
                    args.mark_optical_duplicates, command_line, ctrs)
            else:
                foptical.save_metrics_intermediate(
                    args.mark_optical_duplicates_intermediate, ctrs)

        if want_bqsr:
            from concurrent.futures import ThreadPoolExecutor

            _optical_pool = ThreadPoolExecutor(max_workers=1)
            optical_future = _optical_pool.submit(optical_phase)
            _optical_pool.shutdown(wait=False)
            if args.timed:
                print("Marking optical duplicates (overlapped with "
                      "recalibration).")
        else:
            _timed(args.timed, "Marking optical duplicates.", optical_phase,
                   args.profile, "phase.optical")

    post_sort = sorting_order
    if post_sort != SortingOrder.UNSORTED:
        post_sort = SortingOrder.KEEP
    mapped_fasta = MappedFasta(args.reference) if args.reference else None
    ref_index = RefIndex(mapped_fasta) if mapped_fasta is not None else None

    # Phase 3-5: BQSR, its tables built and applied on the session device
    recal_file = args.bqsr or args.bqsr_tables_only
    sqq = [int(v) for v in args.sqq.split(",") if v]
    if recal_file:
        known = [v for v in args.known_sites.split(",") if v]
        recal = fbqsr.BaseRecalibrator(known, ref_index)
        if bed_obj is not None:
            data.batch = run_pipeline(
                data, [fsimple.remove_non_overlapping_reads(bed_obj)],
                post_sort, device=dev).batch
        if use_sharded:
            from .parallel.mesh import make_mesh
            from .parallel.sharded import sharded_recalibrate

            def recal_fn():
                return sharded_recalibrate(recal, data.header, data.batch,
                                           args.max_cycle, make_mesh(device=dev))
        else:
            def recal_fn():
                return recal.recalibrate(data.header, data.batch, args.max_cycle,
                                         pool=pool, device=dev)
        try:
            tables = _timed(args.timed, "Base recalibration.", recal_fn, args.profile,
                            "phase.bqsr.tables")
        except BaseException:
            # report the overlapped optical thread before the recal
            # error propagates, so it does not fail invisibly
            if optical_future is not None:
                from concurrent.futures import wait as _fwait

                _fwait([optical_future])
                exc = optical_future.exception()
                if exc is not None:
                    print(f"elprep_tpu_torch: optical duplicate marking also "
                          f"failed: {exc}", file=sys.stderr)
            raise
        if optical_future is not None:
            optical_future.result()  # re-raises optical failures
        os.makedirs(os.path.dirname(os.path.abspath(recal_file)) or ".", exist_ok=True)
        if args.bqsr_tables_only and not args.bqsr:
            # raw (pre-finalize) intermediate tables for later combining
            # (reference: print-bqsr.go:301-329 writes gob tables)
            bqsr_report.save_intermediate(tables, recal_file)
        else:
            tables.finalize()
            bqsr_report.print_bqsr_tables(tables, recal_file,
                                          prefix=args.bqsr_tablename_prefix)
        if args.bqsr:  # apply unless tables-only
            def apply_phase():
                return run_pipeline(
                    data, [fbqsr.apply_bqsr_filter(tables, args.quantize_levels, sqq,
                                                   args.max_cycle, device=dev)],
                    post_sort, device=dev)

            data = _timed(args.timed, "Apply BQSR.", apply_phase, args.profile,
                          "phase.bqsr.apply")
    elif args.bqsr_apply:
        tables = bqsr_report.load_and_combine_bqsr_tables(args.bqsr_apply)
        tables.finalize()
        if args.recal_file:
            bqsr_report.print_bqsr_tables(tables, args.recal_file,
                                          prefix=args.bqsr_tablename_prefix)
        data = run_pipeline(
            data, [fbqsr.apply_bqsr_filter(tables, args.quantize_levels, sqq,
                                           args.max_cycle, device=dev)],
            post_sort, device=dev)

    # remaining pipeline (cmd/filter.go:66-140)
    if args.spread_file:
        data = _merge_spread_file(data, args.spread_file, dev)
    pending_write = []
    if args.output not in ("/dev/null", "/dev/zero"):
        def write_phase():
            fmt = args.output_type or ("bam" if args.output.endswith(".bam") else "sam")
            out = run_pipeline(data, filters2, post_sort, device=dev)
            if want_hc:
                # overlap the file write with variant calling; the HC
                # prep rebinds attributes on the shared batch, so the
                # writer serializes its own shallow snapshot
                import copy
                import threading

                snap = copy.copy(out.batch)
                snap_hdr = copy.deepcopy(out.header)
                errs = []

                def _write():
                    try:
                        with trace.span("write.bam"):
                            samio.write_sam_file(args.output, snap_hdr, snap, fmt=fmt)
                    except BaseException as e:  # re-raised after HC
                        errs.append(e)

                th = threading.Thread(target=_write, name="output-writer")
                th.start()
                pending_write.append((th, errs))
            else:
                with trace.span("write.bam"):
                    samio.write_sam_file(args.output, out.header, out.batch, fmt=fmt)
            return out

        data = _timed(args.timed, "Write to file.", write_phase, args.profile,
                      "phase.write")

    try:
        if want_hc:
            _timed(args.timed, "Calling variants.",
                   lambda: _run_haplotypecaller(args, data, mapped_fasta, bed_regions,
                                                command_line, post_sort), args.profile,
                   "phase.hc")
    finally:
        in_flight = sys.exc_info()[0] is not None
        for th, errs in pending_write:
            th.join()
            # don't supplant an in-flight HC exception with the writer's
            if errs and not in_flight:
                raise errs[0]
    return 0


def _nr_workers(args) -> int:
    """Worker processes of the pool: --nr-of-threads, else the CPU
    count; ELPREP_TPU_HC_WORKERS overrides both."""
    if os.environ.get("ELPREP_TPU_HC_WORKERS"):
        return int(os.environ["ELPREP_TPU_HC_WORKERS"])
    return args.nr_of_threads if args.nr_of_threads > 0 else (os.cpu_count() or 1)


def _merge_spread_file(data, spread_file: str, dev):
    """(reference: parseAndMergeSpreadFile, cmd/filter.go:44-64): the
    spread reads of this group's own contigs (its @cs records), merged
    into the coordinate-sorted group."""
    from .core.batch import ReadBatch
    from .core.header import SortingOrder
    from .core.pipeline import SamData, run_pipeline
    from .filters import simple as fsimple
    from .io import sam as samio

    _, spread = samio.read_sam_file(spread_file)
    cs = data.header.contigs()
    if not cs:
        raise ValueError(
            "Cannot call haplotypes on split file without contig information.")
    contigs = {c.encode() if isinstance(c, str) else c for c in cs}
    names_pool = (np.array(spread.names, dtype=bytes) if spread.names
                  else np.array([b""], dtype=bytes))
    keep = np.array([names_pool[spread.rname_id[i]] in contigs
                     for i in range(len(spread))], bool)
    spread = spread.select(keep)
    sd = run_pipeline(SamData(data.header, spread), [fsimple.add_refid],
                      SortingOrder.KEEP, device=dev)
    merged = ReadBatch.concat([data.batch, sd.batch])
    # after the concat the batch is not sorted though the header still
    # says coordinate: drop the claim so the sort really runs (a
    # COORDINATE request on a coordinate header is elided)
    hdr2 = data.header.clone()
    hdr2.hd["SO"] = "unknown"
    return run_pipeline(SamData(hdr2, merged), [fsimple.add_refid],
                        SortingOrder.COORDINATE, device=dev)


def _streaming_phase(args, all_filters, sorting_order) -> None:
    """Overlapped 3-stage pipeline: a reader/parser thread feeds batches
    through a bounded queue, filters run on the main thread, and a
    formatter/writer thread drains a second queue (reference: pargo
    pipeline, sam/filter-pipeline.go:269-296)."""
    import queue
    import threading

    from .core.pipeline import apply_filters, compose_filters, effective_sorting_order
    from .io import sam as samio

    fmt = args.output_type or ("bam" if args.output.endswith(".bam") else "sam")
    q_in: "queue.Queue" = queue.Queue(maxsize=3)
    q_out: "queue.Queue" = queue.Queue(maxsize=3)
    errors: List[BaseException] = []

    def reader():
        try:
            for item in samio.iter_sam_chunks(args.input):
                q_in.put(item)
        except BaseException as e:  # propagate to main
            errors.append(e)
        finally:
            q_in.put(None)

    def writer_thread():
        try:
            with open(args.output, "wb") as f:
                writer = None
                while True:
                    item = q_out.get()
                    if item is None:
                        break
                    hdr, batch = item
                    if writer is None:
                        if fmt == "sam":
                            f.write(samio.format_sam_header(hdr))
                            writer = ("sam", f)
                        else:
                            from .io.bam import StreamingBamWriter

                            writer = ("bam", StreamingBamWriter(f, hdr))
                    if writer[0] == "sam":
                        writer[1].write(samio.format_alignments(batch))
                    else:
                        writer[1].write_batch(batch)
                if writer is not None and writer[0] == "bam":
                    writer[1].close()
        except BaseException as e:
            errors.append(e)
            # drain so the producer can finish
            while q_out.get() is not None:
                pass

    t_read = threading.Thread(target=reader, daemon=True)
    t_write = threading.Thread(target=writer_thread, daemon=True)
    t_read.start()
    t_write.start()
    bfs = None
    while True:
        item = q_in.get()
        if item is None:
            break
        hdr, batch = item
        if bfs is None:
            bfs = compose_filters(hdr, all_filters)
            effective_sorting_order(sorting_order, hdr, hdr.hd_so())
        q_out.put((hdr, apply_filters(batch, bfs)))
    q_out.put(None)
    t_read.join()
    t_write.join()
    if errors:
        raise errors[0]


def _run_haplotypecaller(args, data, mapped_fasta, bed_regions, command_line,
                         post_sort) -> None:
    from .core.pipeline import run_pipeline
    from .filters.hcprep import filter_reads_by_sample_name, haplotype_call_aln
    from .hc import driver as hcdriver
    from .hc.activity import make_hc_params
    from .hc.readblock import ContigReadBlock
    from .io import vcf as vcfmod

    sample_box = [args.sample_name]
    data = run_pipeline(data, [filter_reads_by_sample_name(sample_box),
                               haplotype_call_aln], post_sort)
    params = make_hc_params(args.reference_confidence,
                            assembly_region_padding=args.assembly_region_padding,
                            command_line=command_line)
    params.randomized_qd = bool(args.randomized_qd)
    if args.random_seed_file and os.path.exists(args.random_seed_file):
        with open(args.random_seed_file) as fh:
            content = fh.read().strip()
        if content != "init":
            from .hc.activity import JavaRandom

            params.random = JavaRandom.from_reflect(int(content))

    # normalized reference accessor (fasta.ToUpperAndN semantics)
    _norm = bytes(
        (ord(chr(c).upper()) if chr(c).upper() in "ACGT"
         else (ord("N") if chr(c).upper() in "NRYMKWSBDHV" else c))
        for c in range(256)
    )
    ref_cache: Dict[str, bytes] = {}

    def get_reference(contig: str) -> bytes:
        if contig not in ref_cache:
            seq = mapped_fasta.seq(contig)
            if seq is None:
                raise ValueError(f"contig {contig} not found in reference")
            ref_cache[contig] = np.asarray(seq).tobytes().translate(_norm)
        return ref_cache[contig]

    # columnar batch -> per-contig columnar blocks (coordinate order kept)
    batch = data.batch
    reads_by_contig: Dict[str, ContigReadBlock] = {}
    for rid in np.unique(batch.rname_id) if len(batch) else []:
        nm = batch.names[rid] if 0 <= rid < len(batch.names) else b""
        reads_by_contig[nm.decode()] = ContigReadBlock.from_batch(
            batch, np.flatnonzero(batch.rname_id == rid), nm)

    bed_spans = None
    if bed_regions is not None:
        bed_spans = {c: [(int(s), int(e)) for s, e in ivals]
                     for c, ivals in bed_regions.items()}
    ap = open(args.activity_profile, "w") if args.activity_profile else None
    ar = open(args.assembly_regions, "w") if args.assembly_regions else None
    from .ops.pairhmm import set_pairhmm_mesh

    mh_pid, mh_n = 0, 1
    try:
        # --sharded: the PairHMM's pair batches split over this process's
        # mesh (in a process group too: the dispatch composition depends
        # on the worker pool's drain timing, so no collective may ride
        # inside it). Cleared otherwise, so the module state does not
        # leak into later runs in this process.
        if args.sharded:
            from .parallel.mesh import make_mesh, process_rank_and_count

            mh_pid, mh_n = process_rank_and_count()
            set_pairhmm_mesh(make_mesh())
        else:
            set_pairhmm_mesh(None)
        # process group: contig-partitioned calling with an ordered VCF
        # gather (the reference's per-node sfm HC jobs + CombineVcfOutputs,
        # cmd/sfm.go:769-876, haploutils.go:481-499). Every process
        # derives the identical contiguous partition from the replicated
        # batch, calls variants on its slice only, writes a shard VCF to
        # the shared filesystem, and gathers all shards in contig order.
        hc_out = args.haplotypecaller
        mh_shards = None
        mh_restrict = None
        if mh_n > 1:
            from .parallel.multihost import hc_contig_partition

            # ALL header contigs are partitioned (zero-coverage GVCF bands
            # are emitted per @SQ contig), weighted by read count
            sq_names = [sq["SN"] for sq in data.header.sq]
            owner = hc_contig_partition(
                [len(reads_by_contig.get(nm, ())) for nm in sq_names], mh_n)
            mh_restrict = {nm for i, nm in enumerate(sq_names) if owner[i] == mh_pid}
            reads_by_contig = {nm: blk for nm, blk in reads_by_contig.items()
                               if nm in mh_restrict}
            # the shard exchange rides the shared filesystem: the
            # output's directory, or ELPREP_TPU_HC_SHARD_DIR when each
            # process writes to its own output directory
            shard_dir = os.environ.get(
                "ELPREP_TPU_HC_SHARD_DIR",
                os.path.dirname(os.path.abspath(args.haplotypecaller)) or ".")
            base = os.path.basename(args.haplotypecaller)
            # .gz shards + header sidecars: the gather concatenates the
            # compressed body blocks directly
            mh_shards = [os.path.join(shard_dir, "%s.mh%03d.part.gz" % (base, p))
                         for p in range(mh_n)]
            hc_out = mh_shards[mh_pid]
        os.makedirs(os.path.dirname(os.path.abspath(args.haplotypecaller)) or ".",
                    exist_ok=True)
        # streaming writeback: header first, then records as they come
        sink = vcfmod.AsyncVariantSink(vcfmod.StreamingVcfWriter(
            hc_out,
            hcdriver.write_vcf_header(params, data.header, sample_box[0],
                                      get_reference),
            shard_sidecar=(mh_shards is not None
                           or bool(os.environ.get("ELPREP_TPU_VCF_SHARD")))))
        try:
            # the PairHMM runs on the session device (the CLI's default)
            # or the mesh, fed by the worker pool's batched dispatcher
            hcdriver.call_variants(
                params, data.header, reads_by_contig, get_reference,
                sample_name=sample_box[0], bed_regions=bed_spans,
                use_device_pairhmm=not args.host_pairhmm,
                activity_profile=ap, assembly_regions_out=ar,
                nr_workers=_nr_workers(args), variant_sink=sink,
                restrict_contigs=mh_restrict)
        finally:
            sink.close()
        if mh_n > 1 and params.downsample_fired:
            # per-slice LCG streams: the selection within >50-deep
            # pileups depends on the contig partition, as in the
            # reference's per-job sfm seeding (cmd/sfm.go:634-644)
            print("elprep_tpu_torch: warning: HC downsampling fired in a "
                  "multi-host run; downsampled-read selection uses "
                  "per-contig-slice RNG streams and may differ from a "
                  "single-process run (coverage-equivalent output)",
                  file=sys.stderr, flush=True)
        if mh_shards is not None:
            # all shard VCFs visible -> gather in contig order (process p
            # owns the p-th contiguous contig slice) -> every process
            # writes an identical final VCF -> barrier again before the
            # cleanup, so no process deletes a shard a peer still reads
            from .parallel.multihost import hc_gather_barrier
            from .splitmerge_cli import _combine_vcf_outputs

            hc_gather_barrier("elprep-hc-shards")
            _combine_vcf_outputs(mh_shards, args.haplotypecaller)
            hc_gather_barrier("elprep-hc-gathered")
            for victim in (mh_shards[mh_pid], mh_shards[mh_pid] + ".hdroff"):
                try:
                    os.remove(victim)
                except OSError:
                    pass
    finally:
        set_pairhmm_mesh(None)
        if ap:
            ap.close()
        if ar:
            ar.close()
    if args.random_seed_file and mh_pid == 0:
        # in a process group only process 0 writes (the shared-filesystem
        # path would race; per-slice LCG streams mirror sfm's per-job seeds)
        with open(args.random_seed_file, "w") as f:
            f.write(str(params.random.reflect_seed()))


def vcf_to_elsites(argv: List[str]) -> int:
    """(reference: cmd/convert.go:35-100)"""
    from .io import intervals as iv
    from .io import vcf as vcfmod

    p = argparse.ArgumentParser(prog="elprep_tpu_torch vcf-to-elsites")
    p.add_argument("vcf")
    p.add_argument("elsites")
    args = p.parse_args(argv)
    with open(args.vcf, "rb") as f:
        data = f.read()
    if data[:1] == b"\x1f":
        from .io import bgzf

        data = bgzf.decompress(data)
    by_chrom = vcfmod.scan_vcf_sites(data)
    ivals = {c: iv.flatten(iv.sort_by_start(iv.make([s for s, _ in xs],
                                                    [e for _, e in xs])))
             for c, xs in by_chrom.items()}
    iv.to_elsites_file(ivals, args.elsites)
    return 0


def bed_to_elsites(argv: List[str]) -> int:
    from .io import bed as bedio
    from .io import intervals as iv

    p = argparse.ArgumentParser(prog="elprep_tpu_torch bed-to-elsites")
    p.add_argument("bed")
    p.add_argument("elsites")
    args = p.parse_args(argv)
    bed = bedio.parse_bed(args.bed)
    ivals = {c: iv.flatten(iv.sort_by_start(x)) for c, x in iv.from_bed(bed).items()}
    iv.to_elsites_file(ivals, args.elsites)
    return 0


def fasta_to_elfasta(argv: List[str]) -> int:
    from .io import fasta as fastaio

    p = argparse.ArgumentParser(prog="elprep_tpu_torch fasta-to-elfasta")
    p.add_argument("fasta")
    p.add_argument("elfasta")
    args = p.parse_args(argv)
    contigs = fastaio.parse_fasta(args.fasta)
    fastaio.to_elfasta(contigs, args.elfasta)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from . import native as _native

    _native.tune_malloc()
    if not argv:
        print("elprep_tpu_torch — PyTorch/CUDA secondary-analysis engine\n"
              "commands: filter, split, merge, sfm, "
              "merge-optical-duplicates-metrics, vcf-to-elsites, "
              "bed-to-elsites, fasta-to-elfasta", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    try:
        if cmd == "filter":
            return filter_command(rest)
        if cmd == "vcf-to-elsites":
            return vcf_to_elsites(rest)
        if cmd == "bed-to-elsites":
            return bed_to_elsites(rest)
        if cmd == "fasta-to-elfasta":
            return fasta_to_elfasta(rest)
        if cmd in ("split", "merge", "sfm", "merge-optical-duplicates-metrics"):
            from . import splitmerge_cli

            return splitmerge_cli.run(cmd, rest)
    except _device.DeviceUnavailable as e:
        print(f"elprep_tpu_torch {cmd}: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"elprep_tpu_torch {cmd}: file not found: {e.filename or e}",
              file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"elprep_tpu_torch {cmd}: {e}", file=sys.stderr)
        return 1
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1
