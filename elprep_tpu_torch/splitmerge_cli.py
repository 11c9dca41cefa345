"""split / merge / sfm subcommands
(reference: cmd/split.go, cmd/merge.go, cmd/sfm.go,
cmd/merge-optical-duplicates-metrics.go).

``sfm`` runs split -> per-group filter -> merge. The reference spawns
elprep subprocesses per group (cmd/sfm.go:605-907); here groups run
in-process sequentially by default, so the groups share one card and
one HaplotypeCaller worker pool (its spawn cost is paid once), and
metrics/BQSR-table merging uses the same intermediate-file reductions.
With ``--nr-of-jobs`` > 1 each group runs in a ``python -m
elprep_tpu_torch filter`` subprocess. The compute device is resolved
once, here, and every job gets it (``ELPREP_TPU_TORCH_DEVICE``), so no
two groups run on different devices.

This is the JAX package's elprep_tpu/splitmerge_cli.py with its imports
and program names rewritten and the device passed to the jobs.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
from typing import List

from .core.header import SortingOrder


def run(cmd: str, argv: List[str]) -> int:
    if cmd == "split":
        return split_command(argv)
    if cmd == "merge":
        return merge_command(argv)
    if cmd == "sfm":
        return sfm_command(argv)
    if cmd == "merge-optical-duplicates-metrics":
        return merge_metrics_command(argv)
    return 1


def split_command(argv: List[str]) -> int:
    from . import splitmerge

    p = argparse.ArgumentParser(prog="elprep_tpu_torch split")
    p.add_argument("input")
    p.add_argument("output_path")
    p.add_argument("--output-prefix", default="")
    p.add_argument("--output-type", default="sam")
    p.add_argument("--contig-group-size", type=int, default=0)
    p.add_argument("--single-end", action="store_true")
    p.add_argument("--nr-of-threads", type=int, default=0)
    p.add_argument("--timed", action="store_true")
    args = p.parse_args(argv)
    prefix = args.output_prefix or os.path.basename(args.input).split(".")[0]
    os.makedirs(args.output_path, exist_ok=True)
    splitmerge.split_file_per_chromosome(
        args.input, args.output_path, prefix, args.output_type,
        args.contig_group_size, single_end=args.single_end)
    return 0


def merge_command(argv: List[str]) -> int:
    from . import splitmerge

    p = argparse.ArgumentParser(prog="elprep_tpu_torch merge")
    p.add_argument("input_path")
    p.add_argument("output")
    p.add_argument("--input-prefix", default="")
    p.add_argument("--input-type", default="sam")
    p.add_argument("--output-type", default="")
    p.add_argument("--single-end", action="store_true")
    p.add_argument("--ignore-spread-file", action="store_true",
                   help="merge the group files only, without interleaving "
                        "the spread file (reference: cmd/merge.go)")
    p.add_argument("--nr-of-threads", type=int, default=0)
    p.add_argument("--timed", action="store_true")
    args = p.parse_args(argv)
    input_path = args.input_path
    prefix = args.input_prefix
    if not prefix:
        files = glob.glob(os.path.join(input_path, "*-group00001.*")) + \
            glob.glob(os.path.join(input_path, "*-unmapped.*"))
        if not files:
            print("no split files found", file=sys.stderr)
            return 1
        base = os.path.basename(files[0])
        prefix = base.rsplit("-", 1)[0]
    out_format = args.output_type or ("bam" if args.output.endswith(".bam") else "sam")
    hdr = splitmerge.header_from_any_split_file(input_path, prefix, args.input_type)
    if args.ignore_spread_file:
        splitmerge.merge_files_split_per_chromosome_without_spread(
            input_path, args.output, prefix, args.input_type, out_format, hdr)
    elif hdr.hd_so() == SortingOrder.COORDINATE:
        splitmerge.merge_sorted_files_split_per_chromosome(
            input_path, args.output, prefix, args.input_type, out_format, hdr)
    else:
        splitmerge.merge_unsorted_files_split_per_chromosome(
            input_path, args.output, prefix, args.input_type, out_format, hdr,
            single_end=args.single_end)
    return 0


def sfm_command(argv: List[str]) -> int:
    """(reference: cmd/sfm.go:605-907)"""
    from . import device as _device
    from . import splitmerge
    from .cli import filter_command
    from .filters import optical as foptical

    p = argparse.ArgumentParser(prog="elprep_tpu_torch sfm", allow_abbrev=False)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--intermediate-files-output-type", default="sam")
    p.add_argument("--contig-group-size", type=int, default=0)
    p.add_argument("--single-end", action="store_true")
    p.add_argument("--tmp-path", default="")
    p.add_argument("--mark-optical-duplicates", default="")
    p.add_argument("--haplotypecaller", default="")
    p.add_argument("--nr-of-jobs", type=int, default=1,
                   help="process per contig group, N at a time (the "
                        "reference runs one subprocess at a time, "
                        "cmd/sfm.go:612; >1 is an extension — each job "
                        "starts a fresh RNG stream)")
    # remaining args forwarded to per-group filter invocations
    args, passthrough = p.parse_known_args(argv)
    # one device for every job, resolved here (a missing card fails now)
    dev = _device.default_device_from_env()

    tmp_root = args.tmp_path or tempfile.mkdtemp(prefix="elprep_tpu_torch_sfm_")
    os.makedirs(tmp_root, exist_ok=True)
    prefix = os.path.basename(args.input).split(".")[0]
    ext = args.intermediate_files_output_type

    # phase 1: split
    splitmerge.split_file_per_chromosome(
        args.input, tmp_root, prefix, ext, args.contig_group_size,
        single_end=args.single_end)
    splits_dir = os.path.join(tmp_root, "splits")
    filtered_dir = os.path.join(tmp_root, "filtered")
    os.makedirs(filtered_dir, exist_ok=True)

    metrics_dir = os.path.join(tmp_root, "metrics")
    vcfs_dir = os.path.join(tmp_root, "vcfs")
    os.makedirs(metrics_dir, exist_ok=True)
    os.makedirs(vcfs_dir, exist_ok=True)

    # job runner: sequential in-process, or a subprocess pool with -j>1
    # (reference pattern: exec.Command(os.Args[0], ...), cmd/sfm.go:612)
    def run_jobs(job_argvs) -> int:
        # per-group HC outputs are gather shards: have their writers
        # flush the VCF header at a BGZF block boundary + drop a .hdroff
        # sidecar so _combine_vcf_outputs can concatenate body blocks
        # without recompressing (scoped: a later whole-file run in this
        # process must not inherit shard framing)
        os.environ["ELPREP_TPU_VCF_SHARD"] = "1"
        try:
            return _run_jobs_inner(job_argvs)
        finally:
            os.environ.pop("ELPREP_TPU_VCF_SHARD", None)

    def _run_jobs_inner(job_argvs) -> int:
        if args.nr_of_jobs > 1 and len(job_argvs) > 1:
            import subprocess
            import sys as _sys
            from concurrent.futures import ThreadPoolExecutor

            pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            env = dict(os.environ)
            env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
            env[_device.ENV_VAR] = str(dev)

            def run_one(fargv):
                return subprocess.run(
                    [_sys.executable, "-m", "elprep_tpu_torch", "filter"] + fargv,
                    env=env).returncode
            with ThreadPoolExecutor(max_workers=args.nr_of_jobs) as pool:
                for rc in pool.map(run_one, job_argvs):
                    if rc != 0:
                        return rc
            return 0
        for fargv in job_argvs:
            rc = filter_command(fargv)
            if rc != 0:
                return rc
        return 0

    def metrics_args(base: str):
        if not args.mark_optical_duplicates:
            return []
        return ["--mark-optical-duplicates-intermediate",
                os.path.join(metrics_dir, base + ".metrics")]

    group_files = sorted(glob.glob(os.path.join(splits_dir, prefix + "-*." + ext)))
    spread_file = os.path.join(tmp_root, prefix + "-spread." + ext)
    spread_base = os.path.basename(spread_file)
    have_spread = (not args.single_end) and os.path.exists(spread_file)

    pt = list(passthrough)
    # nested filter invocations carry the sfm command as their @PG CL
    # (reference: cmd/sfm.go:599,842)
    if "--pg-cmd-line" not in pt:
        pt += ["--pg-cmd-line", "elprep_tpu_torch sfm " + " ".join(argv)]
    bqsr_out = None
    if "--bqsr" in pt:
        i = pt.index("--bqsr")
        bqsr_out = pt[i + 1]
        pt = pt[:i] + pt[i + 2:]

    def copy_flags(names, flags=()):
        out = []
        for f in names:
            if f in pt:
                out += [f, pt[pt.index(f) + 1]]
        for f in flags:
            if f in pt:
                out.append(f)
        return out

    out_format = "bam" if args.output.endswith(".bam") else "sam"

    if bqsr_out is None:
        # phase 2: spread first (reference: cmd/sfm.go:709-731), so
        # per-group HC jobs see the deduplicated spread reads
        spread_filtered = os.path.join(filtered_dir, spread_base)
        if have_spread:
            rc = run_jobs([[spread_file, spread_filtered] + pt
                           + metrics_args(spread_base)])
            if rc != 0:
                return rc
        jobs = []
        for gf in group_files:
            base = os.path.basename(gf)
            fargv = [gf, os.path.join(filtered_dir, base)] + pt + metrics_args(base)
            if args.haplotypecaller and "unmapped" not in base:
                fargv += ["--haplotypecaller",
                          os.path.join(vcfs_dir, base + ".vcf.gz")]
                if have_spread:
                    fargv += ["--spread-file", spread_filtered]
            jobs.append(fargv)
        rc = run_jobs(jobs)
        if rc != 0:
            return rc
        hdr = splitmerge.header_from_any_split_file(filtered_dir, prefix, ext)
        if args.haplotypecaller and have_spread:
            # the group outputs already contain their contig-filtered
            # spread reads (merged by --spread-file before writing), so
            # interleaving the spread file again would duplicate them
            splitmerge.merge_files_split_per_chromosome_without_spread(
                filtered_dir, args.output, prefix, ext, out_format, hdr)
        elif hdr.hd_so() == SortingOrder.COORDINATE:
            splitmerge.merge_sorted_files_split_per_chromosome(
                filtered_dir, args.output, prefix, ext, out_format, hdr)
        else:
            splitmerge.merge_unsorted_files_split_per_chromosome(
                filtered_dir, args.output, prefix, ext, out_format, hdr,
                single_end=args.single_end)
    else:
        # BQSR phase 1: per file (groups + spread) filter +
        # --bqsr-tables-only (reference: cmd/sfm.go:655-708)
        tabs_dir = os.path.join(tmp_root, "tabs")
        mid_dir = os.path.join(tmp_root, "mid")
        os.makedirs(tabs_dir, exist_ok=True)
        os.makedirs(mid_dir, exist_ok=True)
        jobs = []
        for gf in group_files:
            base = os.path.basename(gf)
            jobs.append([gf, os.path.join(mid_dir, base)] + pt
                        + ["--bqsr-tables-only",
                           os.path.join(tabs_dir, base + ".elrecal")]
                        + metrics_args(base))
        if have_spread:
            jobs.append([spread_file, os.path.join(mid_dir, spread_base)] + pt
                        + ["--bqsr-tables-only",
                           os.path.join(tabs_dir, spread_base + ".elrecal")]
                        + metrics_args(spread_base))
        rc = run_jobs(jobs)
        if rc != 0:
            return rc
        apply_args = (["--bqsr-apply", tabs_dir, "--recal-file", bqsr_out]
                      + copy_flags(("--reference", "--max-cycle",
                                    "--quantize-levels", "--sqq",
                                    "--remove-optional-fields",
                                    "--keep-optional-fields"),
                                   flags=("--pedantic",)))
        if not args.haplotypecaller:
            # phase 2: merge mid (spread interleaved) -> one apply pass
            # (reference pipes merge into filter, cmd/sfm.go:769-805)
            hdr = splitmerge.header_from_any_split_file(mid_dir, prefix, ext)
            merged_tmp = os.path.join(tmp_root, "merged-for-apply." + ext)
            if hdr.hd_so() == SortingOrder.COORDINATE:
                splitmerge.merge_sorted_files_split_per_chromosome(
                    mid_dir, merged_tmp, prefix, ext, ext, hdr)
            else:
                splitmerge.merge_unsorted_files_split_per_chromosome(
                    mid_dir, merged_tmp, prefix, ext, ext, hdr,
                    single_end=args.single_end)
            rc = run_jobs([[merged_tmp, args.output,
                            "--output-type", out_format] + apply_args])
            if rc != 0:
                return rc
        else:
            # phase 2: apply on the spread file, then apply+HC per group
            # (reference: cmd/sfm.go:806-866)
            applied_spread = os.path.join(mid_dir, "apply-bqsred-" + spread_base)
            if have_spread:
                rc = run_jobs([[os.path.join(mid_dir, spread_base),
                                applied_spread] + apply_args])
                if rc != 0:
                    return rc
            hc_extra = copy_flags(("--reference-confidence", "--sample-name",
                                   "--activity-profile", "--assembly-regions",
                                   "--random-seed-file", "--target-regions",
                                   "--assembly-region-padding"))
            jobs = []
            for gf in group_files:
                base = os.path.basename(gf)
                fargv = [os.path.join(mid_dir, base),
                         os.path.join(filtered_dir, base)] + apply_args
                if "unmapped" not in base:
                    fargv += ["--haplotypecaller",
                              os.path.join(vcfs_dir, base + ".vcf.gz")] + hc_extra
                    if have_spread:
                        fargv += ["--spread-file", applied_spread]
                jobs.append(fargv)
            rc = run_jobs(jobs)
            if rc != 0:
                return rc
            hdr = splitmerge.header_from_any_split_file(filtered_dir, prefix, ext)
            # merge WITHOUT spread: the sr:i:1 copies in the group files
            # carry the recalibrated cross-group reads
            # (reference: merge --ignore-spread-file, cmd/sfm.go:866-877)
            splitmerge.merge_files_split_per_chromosome_without_spread(
                filtered_dir, args.output, prefix, ext, out_format, hdr)

    # phase 4: metric + VCF reductions (gob -> JSON/concat equivalents)
    if args.mark_optical_duplicates:
        paths = sorted(glob.glob(os.path.join(metrics_dir, "*.metrics")))
        ctrs = foptical.load_and_combine_metrics(paths)
        foptical.print_duplicates_metrics(
            args.mark_optical_duplicates, "elprep_tpu_torch sfm " + " ".join(argv), ctrs)
    if args.haplotypecaller:
        _combine_vcf_outputs(sorted(glob.glob(os.path.join(vcfs_dir, "*.vcf.gz"))),
                             args.haplotypecaller)
    return 0


def _combine_vcf_outputs(paths: List[str], output: str) -> None:
    """(reference: CombineVcfOutputs, haploutils.go:481-499): concatenate
    per-split VCFs, header from the first.

    Fast path: when the output is .gz and every shard is a BGZF file
    with a ``.hdroff`` sidecar (written by StreamingVcfWriter's shard
    mode: the header ends at a block boundary at the recorded offset),
    the gather is a pure BYTE concatenation of already-compressed body
    blocks — shard 0 minus its EOF marker, each later shard minus its
    header blocks and EOF, one final EOF. The reference (and the slow
    path below) decompresses and recompresses every record instead —
    measured 13.9 s/process at 500k reads vs sub-second block concat."""
    from .io import bgzf

    if output.endswith(".gz") and all(
            p.endswith(".gz") and os.path.exists(p + ".hdroff")
            for p in paths):
        tmp = "%s.tmp.%d" % (output, os.getpid())
        with open(tmp, "wb") as out_f:
            for i, path in enumerate(paths):
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    f.seek(max(0, size - len(bgzf.BGZF_EOF)))
                    if f.read() != bgzf.BGZF_EOF:
                        raise ValueError(f"{path}: missing BGZF EOF marker")
                    start = 0
                    if i > 0:
                        start = int(open(path + ".hdroff").read().strip())
                    # stream the body-block byte range: shards can be
                    # hundreds of MB at WGS scale and every multihost
                    # process gathers concurrently — constant memory,
                    # not a whole-shard read
                    f.seek(start)
                    remaining = size - len(bgzf.BGZF_EOF) - start
                    while remaining > 0:
                        chunk = f.read(min(remaining, 8 << 20))
                        if not chunk:
                            raise ValueError(f"{path}: truncated shard")
                        out_f.write(chunk)
                        remaining -= len(chunk)
            out_f.write(bgzf.BGZF_EOF)
        os.replace(tmp, output)
        return

    bodies = []
    header = None
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            data = f.read()
        if data[:1] == b"\x1f":
            data = bgzf.decompress(data)
        lines = data.split(b"\n")
        body_start = 0
        for j, line in enumerate(lines):
            if line.startswith(b"#"):
                body_start = j + 1
            else:
                break
        if header is None:
            header = b"\n".join(lines[:body_start]) + b"\n" if body_start else b""
        body = b"\n".join(l for l in lines[body_start:] if l)
        if body:
            bodies.append(body)
    out = (header or b"") + (b"\n".join(bodies) + b"\n" if bodies else b"")
    if output.endswith(".gz"):
        out = bgzf.compress(out)
    # atomic replace: under multi-host every process gathers the same
    # final VCF, possibly onto one shared output path (identical bytes,
    # but partial interleaved writes must never be observable)
    tmp = "%s.tmp.%d" % (output, os.getpid())
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, output)


def merge_metrics_command(argv: List[str]) -> int:
    """(reference: cmd/merge-optical-duplicates-metrics.go:42-127 —
    positionals are input, output, metrics, intermediate-metrics dir;
    input/output only feed the embedded command line)."""
    from .filters import optical as foptical

    p = argparse.ArgumentParser(prog="elprep_tpu_torch merge-optical-duplicates-metrics")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("metrics")
    p.add_argument("intermediate_metrics")
    p.add_argument("--remove-duplicates", action="store_true")
    p.add_argument("--nr-of-threads", type=int, default=0)
    p.add_argument("--timed", action="store_true")
    p.add_argument("--profile", default="")
    p.add_argument("--log-path", default="")
    args = p.parse_args(argv)
    command = "elprep_tpu_torch merge-optical-duplicates-metrics %s %s %s %s" % (
        args.input, args.output, args.metrics, args.intermediate_metrics)
    if args.remove_duplicates:
        command += " --remove-duplicates"
    paths = sorted(glob.glob(os.path.join(args.intermediate_metrics, "*")))
    ctrs = foptical.load_and_combine_metrics(paths)
    foptical.print_duplicates_metrics(args.metrics, command, ctrs)
    return 0
