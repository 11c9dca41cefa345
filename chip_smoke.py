#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elprep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dispatch-ab ROUNDS

Phases, each of which must pass:

1. build: compile the port's CUDA kernels from the sources in this
   checkout (csrc/*.cu, one nvcc each, started together);
2. kernel: the PairHMM kernels at full width (8192 pairs, the pooled
   dispatch size; reads 100-151 bp, haplotypes 250-600 bp, some 'N'
   bases), through the warp path (which the plan picks for them) and,
   forced, the CTA path, each against the plain PyTorch version on the
   card (bit for bit); the warp path against the f64 oracle on 64
   sampled pairs (within 5e-4 log10); each path's time in turns in this
   run, the plain version's time and the bound; then 256 pairs with
   reads of 300-1500 bp, which only the CTA path takes, against the plain
   version;
3. golden: the port's CLI on cuda reproduces the duplicate-marking,
   metrics, BQSR and HaplotypeCaller goldens of tests/fixtures byte for
   byte (the HaplotypeCaller on the worker pool, started before this
   phase at the CLI's default size, the CPU count, and checked off the
   card: every worker on the CPU without a CUDA context, nvidia-smi
   listing no other process on the card);
4. device ops: on the 5-step fixture (below), the duplicate mask, the six
   BQSR tables and the recalibrated quals computed on the card are
   bit-equal to their host twins (the CPU route's numpy/native engines),
   with each one's card time, host twin time and bytes bound;
5. 5-step: ``filter --mark-duplicates --mark-optical-duplicates
   --sorting-order coordinate --bqsr --known-sites --haplotypecaller
   --reference-confidence GVCF`` (bench.py's command) on 120 000 reads
   over a 2 Mb genome (bench.py's fixture shape: 118 000 sampled reads
   from a genome with planted SNPs, the planted SNPs as known sites, and
   2 000 duplicates with Illumina qnames within optical distance), run
   pooled from cold (the CLI's default worker count, the pool stopped
   before it, so the wall holds the spawn as a user's single run does),
   pooled again on the warm pool, and serially
   (ELPREP_TPU_HC_WORKERS=1); each run: every record written,
   coordinate-sorted, duplicates and optical duplicates found, the recal
   report's read-group row, ALT calls in the GVCF, the device programs
   run on the card, every PairHMM launch on the warp path, the phase
   walls of --timed, launches and pairs per launch; the pooled runs got
   one pool, its workers are still off the card, and their BAM records,
   recal report, metrics body and GVCF body are byte-equal to the serial
   run's;
6. sfm: ``sfm`` with the same options, one job at a time in this
   process, every contig group on the one pool: the BAM records and the
   GVCF body of the whole-file pooled run;
7. slice: the earlier ``filter --sorting-order coordinate
   --haplotypecaller --reference-confidence GVCF`` on 30 000 reads, its
   launches again all on the warp path.

Prints the card (nvidia-smi name and power limit), one JSON line with
the device programs' numbers, one with the kernels' numbers (launches
from the cold pooled 5-step run, the warm and serial runs' beside them),
and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repository. Imports nothing of JAX and nothing of elprep_tpu.

``--dispatch-ab ROUNDS`` runs only the build and the 5-step run, pooled
on one warm pool, with 1 and 2 PairHMM dispatch threads
(ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS) in turns, 1 2 then 2 1, for
ROUNDS rounds, after one untimed run, and prints the walls as its last
line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(REPO, "tests")
FIXTURES = os.path.join(TESTS, "fixtures")

# H100 SXM peaks (NVIDIA data sheet): non-tensor float32 and HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the PairHMM kernels' own ceiling: built with -fmad=false, every f32
# operation is one FMUL or FADD, at most one per lane per clock (132 SMs x
# 128 lanes x 1.98 GHz), half the FMA-counting peak above
PEAK_F32_OPS_NO_FMA = 132 * 128 * 1.98e9
# f32 operations per DP cell: the function needs 11 (7 multiplies, 4 adds,
# with (I2 + D2) * i2m as one multiply); the kernels' bit-exact order
# multiplies I2 and D2 by i2m apart, one multiply more
OPS_PER_CELL = 11
KERNEL_OPS_PER_CELL = 12

KERNEL_PAIRS = 8192
FIVE_STEP_READS = 120_000
SLICE_READS = 30_000
SLICE_CONTIGS = [("chr1", 1_200_000), ("chr2", 800_000)]


def _log(msg: str) -> None:
    print(msg, flush=True)


def _median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def _median_ms_turns(fns: dict, reps: int) -> dict:
    """Median CUDA-event ms of each of ``fns`` over ``reps`` rounds taken
    in turns (the order reversed every other round), after one warm-up
    each: versions compared on one card in one run."""
    import torch

    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    order = list(fns)
    for k in range(reps):
        for name in (order if k % 2 == 0 else order[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[name]()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------


def build_phase() -> dict:
    """Build every kernel library of the port, one nvcc per source, all
    started together; returns seconds per kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from elprep_tpu_torch.ops import pairhmm_cuda

    builders = {"pairhmm": pairhmm_cuda.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as ex:
        libs = {k: ex.submit(f) for k, f in builders.items()}
        libs = {k: f.result() for k, f in libs.items()}
    _log("build: %.1f s wall" % (time.perf_counter() - t0))
    for name, lib in libs.items():
        _log("build %s: %.1f s; ptxas: %s" % (
            name, lib.build_seconds,
            " | ".join(ln.strip() for ln in lib.build_log.splitlines()
                       if "registers" in ln or "spill" in ln)[:2000]))
    return {k: lib.build_seconds for k, lib in libs.items()}


# ---------------------------------------------------------------------------
# Phase 2: the PairHMM kernel at full width
# ---------------------------------------------------------------------------


def make_pairs(n_pairs: int, seed: int, reads_per_region: int = 8,
               haps_per_region: int = 4, read_len=(100, 151), hap_len=(250, 600)):
    """Synthetic HaplotypeCaller dispatch: regions of ``haps_per_region``
    haplotypes (``hap_len`` bp, by default 250-600, mutated copies of one
    reference window) and ``reads_per_region`` reads (``read_len`` bp, by
    default 100-151, sampled from a haplotype with 2% errors and some 'N'
    bases), every read against every haplotype of its region. Returns
    (reads, haps, pair_r, pair_h)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads, haps, pair_r, pair_h = [], [], [], []
    per_region = reads_per_region * haps_per_region
    for _ in range(-(-n_pairs // per_region)):
        ref = rng.choice(acgt, rng.randint(hap_len[0], hap_len[1] + 1))
        h0 = len(haps)
        for k in range(haps_per_region):
            h = ref.copy()
            if k:
                for p in rng.randint(0, len(h), 3):
                    h[p] = rng.choice(acgt)
                cut = rng.randint(20, len(h) - 20)
                h = (np.delete(h, range(cut, cut + rng.randint(1, 6))) if k % 2
                     else np.insert(h, cut, rng.choice(acgt, rng.randint(1, 6))))
            haps.append(h.tobytes())
        r0 = len(reads)
        for _ in range(reads_per_region):
            src = np.frombuffer(haps[h0 + rng.randint(haps_per_region)], np.uint8)
            lr = rng.randint(read_len[0], read_len[1] + 1)
            st = rng.randint(0, len(src) - lr + 1)
            seq = src[st : st + lr].copy()
            err = rng.rand(lr) < 0.02
            seq[err] = rng.choice(acgt, int(err.sum()))
            seq[rng.rand(lr) < 0.01] = ord("N")
            qual = rng.randint(2, 41, lr).astype(np.uint8)
            reads.append((seq.tobytes(), qual, int(rng.randint(20, 61))))
        for r in range(reads_per_region):
            for h in range(haps_per_region):
                pair_r.append(r0 + r)
                pair_h.append(h0 + h)
    return (reads, haps, np.asarray(pair_r[:n_pairs], np.int64),
            np.asarray(pair_h[:n_pairs], np.int64))


def _bound_ms(batch, cells: int) -> tuple:
    """(operations bound, bytes bound) in ms: OPS_PER_CELL f32 operations
    per cell at the non-tensor f32 peak; the packed inputs read once and
    the f32 outputs written once at the HBM rate."""
    ops_ms = OPS_PER_CELL * cells / PEAK_F32_FLOPS * 1e3
    bytes_ms = (batch.blob.numel() + 4 * batch.n_pairs) / PEAK_BYTES_PER_S * 1e3
    return ops_ms, bytes_ms


def _cells(reads, haps, pair_r, pair_h) -> int:
    import numpy as np

    lr = np.array([len(reads[r][1]) for r in pair_r], np.int64)
    lh = np.array([len(haps[h]) for h in pair_h], np.int64)
    return int((lr * lh).sum())


def _check_equal(name: str, got, plain) -> float:
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - plain).abs().max())
    _log("%s vs plain: max abs diff %r, bitwise equal %s"
         % (name, err, bool(torch.equal(got, plain))))
    if not torch.equal(got, plain):
        raise AssertionError(f"{name} differs from the plain version: {err!r}")
    return err


def kernel_phase(n_pairs: int = KERNEL_PAIRS, reps: int = 20,
                 n_sample: int = 64) -> dict:
    """The pooled dispatch size through both kernels (forced: the warp
    path, which the plan picks for these reads, and the CTA path), each
    bit-equal to the plain version; then a long-read batch that only the
    CTA path takes."""
    import numpy as np
    import torch

    from elprep_tpu_torch.ops import pairhmm as ph
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    device = "cuda"
    reads, haps, pair_r, pair_h = make_pairs(n_pairs, seed=5)
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(device)
    tabs = pc.default_tables(device)
    plan = pc.launch_plan(batch.max_read_len)
    if plan[0] != "warp":
        raise AssertionError(f"{n_pairs} short-read pairs planned on {plan}")
    plain = pc.pairhmm_forward_plain(batch, tabs)
    got = pc._pairhmm_forward_path(batch, tabs, "warp")
    cta = pc._pairhmm_forward_path(batch, tabs, "cta")
    torch.cuda.synchronize()
    err = max(_check_equal(f"warp kernel {plan}, {n_pairs} pairs", got, plain),
              _check_equal(f"cta kernel {pc.launch_plan(batch.max_read_len, 'cta')}, "
                           f"{n_pairs} pairs", cta, plain))

    # f64 oracle on sampled pairs that the pipeline keeps from f32
    acc = got.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        logl = np.log10(acc) - pc.F32_INITIAL_POW * np.log10(2.0)
    kept = np.flatnonzero(np.isfinite(logl) & (logl >= ph.F32_RESCUE_LOG10))
    rng = np.random.RandomState(6)
    sample = rng.choice(kept, min(n_sample, len(kept)), replace=False)
    worst = 0.0
    for b in sample:
        seq, qual, mapq = reads[pair_r[b]]
        exact = ph.pairhmm_f64_diag(seq, qual, mapq, haps[pair_h[b]])
        worst = max(worst, abs(logl[b] - exact))
    _log("kernel vs f64 oracle: %d sampled of %d pairs kept from f32 "
         "(%d rescued in f64): max |log10 diff| %.3g"
         % (len(sample), len(kept), n_pairs - len(kept), worst))
    if len(sample) < n_sample or worst >= 5e-4:
        raise AssertionError(f"f64 oracle check failed: {len(sample)} pairs, {worst}")

    cells = _cells(reads, haps, pair_r, pair_h)
    ops_ms, bytes_ms = _bound_ms(batch, cells)
    times = _median_ms_turns({
        "warp": lambda: pc._pairhmm_forward_path(batch, tabs, "warp"),
        "cta": lambda: pc._pairhmm_forward_path(batch, tabs, "cta"),
    }, reps)
    plain_ms = _median_ms(lambda: pc.pairhmm_forward_plain(batch, tabs), 3)
    ceiling_ms = OPS_PER_CELL * cells / PEAK_F32_OPS_NO_FMA * 1e3
    kernel_ceiling_ms = KERNEL_OPS_PER_CELL * cells / PEAK_F32_OPS_NO_FMA * 1e3
    paths = {}
    for name, ms in times.items():
        paths[name] = {"ms": ms, "gcups": cells / ms / 1e6, "pairs": n_pairs,
                       "cells": cells, "bound_ms": max(ops_ms, bytes_ms)}
        _log("pairhmm %s: %d pairs, %d cells: %.4f ms median of %d (%.2f GCUPS); "
             "bound %.4f ms (operations; bytes %.6f ms), %.1fx off it; without "
             "FMA at best %.4f ms, %.1fx off that (%.4f ms at the kernels' %d "
             "operations per cell)"
             % (name, n_pairs, cells, ms, reps, cells / ms / 1e6, ops_ms, bytes_ms,
                ms / ops_ms, ceiling_ms, ms / ceiling_ms, kernel_ceiling_ms,
                KERNEL_OPS_PER_CELL))
    _log("pairhmm: warp path %.2fx faster than the cta path (same run, same "
         "pairs); plain version %.2f ms" % (times["cta"] / times["warp"], plain_ms))

    # long reads: only the CTA path takes them
    lreads, lhaps, lpr, lph = make_pairs(256, seed=8, read_len=(300, 1500),
                                         hap_len=(1600, 2400))
    lbatch = pc.pack_pairs(lreads, lhaps, lpr, lph).to(device)
    lplan = pc.launch_plan(lbatch.max_read_len)
    if lplan[0] != "cta":
        raise AssertionError(f"long-read batch planned on {lplan}")
    lplain = pc.pairhmm_forward_plain(lbatch, tabs)
    lgot = pc.pairhmm_forward(lbatch, tabs)
    torch.cuda.synchronize()
    err = max(err, _check_equal(f"cta kernel {lplan}, 256 long-read pairs", lgot, lplain))
    lcells = _cells(lreads, lhaps, lpr, lph)
    lops_ms, lbytes_ms = _bound_ms(lbatch, lcells)
    lms = _median_ms(lambda: pc.pairhmm_forward(lbatch, tabs), reps)
    paths["cta_long"] = {"ms": lms, "gcups": lcells / lms / 1e6, "pairs": 256,
                         "cells": lcells, "bound_ms": max(lops_ms, lbytes_ms)}
    _log("pairhmm cta_long: 256 pairs (reads 300-1500, haps 1600-2400), %d cells: "
         "%.4f ms median of %d (%.2f GCUPS); bound %.4f ms (operations; bytes "
         "%.6f ms)" % (lcells, lms, reps, lcells / lms / 1e6, lops_ms, lbytes_ms))
    return {"name": "pairhmm_forward", "route": "cuda",
            "source": "elprep_tpu_torch/csrc/pairhmm.cu",
            "replaces": "elprep_tpu/ops/pairhmm_pallas.py:39",
            "max_abs_err": err, "ms": times["warp"], "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "cells": cells, "pairs": n_pairs, "paths": paths}


# ---------------------------------------------------------------------------
# Phase 3: HaplotypeCaller goldens through the CLI
# ---------------------------------------------------------------------------


def _mask(data: bytes) -> bytes:
    return b"\n".join(
        b"##elPrepCommandLine=<masked>" if ln.startswith(b"##elPrepCommandLine")
        else ln for ln in data.split(b"\n"))


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def golden_phase(workdir: str) -> None:
    """The repository's hand-verified goldens through the port's CLI on
    cuda: duplicate marking + sort, the duplication metrics, the BQSR
    report (tests/test_golden.py's arguments) and the HaplotypeCaller."""
    from elprep_tpu_torch import cli

    def run(argv, what):
        rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"golden {what}: rc {rc}")

    out = os.path.join(workdir, "dedup_golden.sam")
    run(["filter", os.path.join(FIXTURES, "dedup_golden.in.sam"), out,
         "--mark-duplicates", "--sorting-order", "coordinate", "--pg-cmd-line",
         "elprep filter dedup_golden.in.sam dedup_golden.out.sam "
         "--mark-duplicates --sorting-order coordinate"], "dedup")
    metrics = os.path.join(workdir, "metrics_golden.txt")
    run(["filter", os.path.join(FIXTURES, "metrics_golden.in.sam"),
         os.path.join(workdir, "metrics_golden.sam"), "--mark-duplicates",
         "--mark-optical-duplicates", metrics, "--sorting-order", "coordinate"],
        "metrics")
    bqsr_ref = os.path.join(workdir, "bqsr_golden.elfasta")
    run(["fasta-to-elfasta", os.path.join(FIXTURES, "bqsr_golden.ref.fasta"), bqsr_ref],
        "bqsr reference")
    recal = os.path.join(workdir, "bqsr_golden.recal")
    run(["filter", os.path.join(FIXTURES, "bqsr_golden.in.sam"),
         os.path.join(workdir, "bqsr_golden.sam"), "--bqsr", recal, "--reference",
         bqsr_ref], "bqsr")
    got_metrics = _read(metrics)
    for got, name in ((_read(out), "dedup_golden.expected.sam"),
                      (got_metrics[got_metrics.index(b"## METRICS CLASS"):],
                       "metrics_golden.expected.txt"),
                      (_read(recal), "bqsr_golden.expected.recal")):
        if got != _read(os.path.join(FIXTURES, name)):
            raise AssertionError(f"golden: output differs from {name}")
        _log(f"golden: byte-equal to {name}")

    ref = os.path.join(workdir, "golden_ref.elfasta")
    if cli.main(["fasta-to-elfasta", os.path.join(FIXTURES, "hc_golden.ref.fasta"),
                 ref]) != 0:
        raise AssertionError("fasta-to-elfasta failed")
    for mode, ext in (("NONE", "vcf"), ("GVCF", "gvcf")):
        out = os.path.join(workdir, f"golden_{mode}.vcf")
        rc = cli.main(["filter", os.path.join(FIXTURES, "hc_golden.in.sam"),
                       os.path.join(workdir, f"golden_{mode}.sam"),
                       "--reference", ref, "--haplotypecaller", out,
                       "--reference-confidence", mode])
        if rc != 0:
            raise AssertionError(f"golden {mode}: rc {rc}")
        with open(out, "rb") as fh:
            got = _mask(fh.read())
        with open(os.path.join(FIXTURES, f"hc_golden.expected.{ext}"), "rb") as fh:
            want = fh.read()
        if got != want:
            raise AssertionError(f"golden {mode}: output differs from "
                                 f"hc_golden.expected.{ext}")
        _log(f"golden {mode}: byte-equal to hc_golden.expected.{ext}")


# ---------------------------------------------------------------------------
# Fixtures of the slices: the JAX package's end-to-end shape (bench.py)
# ---------------------------------------------------------------------------


def make_reference(workdir: str, contigs=SLICE_CONTIGS) -> dict:
    """The synthetic genome of bench.py (seed 7) as .elfasta, and a copy of
    it with a SNP planted about every kilobase, from which the reads are
    sampled, so the HaplotypeCaller finds active regions to assemble and
    score. Returns {"alt", "snps" [(contig, 0-based pos)], "elfasta"}."""
    import random

    import samgen

    from elprep_tpu_torch import cli

    genome = samgen.make_genome(contigs, seed=7)
    rng = random.Random(19)
    alt, snps = {}, []
    for name, ln in contigs:
        seq = bytearray(genome[name])
        for p in range(rng.randrange(500, 1500), ln, 1000):
            p += rng.randrange(-300, 300)
            if seq[p : p + 1] in (b"A", b"C", b"G", b"T"):
                seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
                snps.append((name, p))
        alt[name] = bytes(seq)
    fasta = os.path.join(workdir, "slice.fasta")
    with open(fasta, "w") as fh:
        for name, _ in contigs:
            seq = genome[name].decode()
            fh.write(f">{name}\n")
            fh.write("\n".join(seq[k : k + 70] for k in range(0, len(seq), 70)) + "\n")
    elfasta = os.path.join(workdir, "slice.elfasta")
    if cli.main(["fasta-to-elfasta", fasta, elfasta]) != 0:
        raise AssertionError("fasta-to-elfasta failed")
    return {"alt": alt, "snps": snps, "elfasta": elfasta}


def _header(contigs):
    import samgen

    return samgen.make_header_lines(
        contigs, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "unit1"}])


def make_slice_fixture(workdir: str, ref: dict, n_reads: int,
                       contigs=SLICE_CONTIGS) -> str:
    """100 bp read pairs (tests/samgen.py, seed 11) from the planted
    genome. Returns the SAM path."""
    import samgen

    lines = samgen.reads_from_genome(n_reads, contigs, ref["alt"], seed=11,
                                     rg_ids=["rg1"])
    sam = os.path.join(workdir, "slice.sam")
    with open(sam, "w") as fh:
        fh.write("\n".join(_header(contigs) + lines) + "\n")
    return sam


def realign_soft_clips(lines: list) -> list:
    """tests/samgen.reads_from_genome samples a soft-clipped first mate's
    bases from POS on, so its aligned part sits one clip length off the
    reference: about 9% of all aligned bases then mismatch, BQSR
    (correctly) recalibrates nearly every base to Q10 or so, and the
    HaplotypeCaller, which drops bases at or below Q10, has nothing left
    to call. Move such a read's POS (and its mate's PNEXT) by the clip
    length, where its bases came from. Returns new SAM lines."""
    import re

    shift = {}
    rows = [ln.split("\t") for ln in lines]
    for f in rows:
        m = re.match(r"(\d+)S", f[5])
        if m:
            shift[f[0]] = int(m.group(1))
            f[3] = str(int(f[3]) + shift[f[0]])
    for f in rows:
        if f[0] in shift and not re.match(r"\d+S", f[5]):
            f[7] = str(int(f[7]) + shift[f[0]])
    return ["\t".join(f) for f in rows]


def make_five_step_fixture(workdir: str, ref: dict, n_reads: int = FIVE_STEP_READS,
                           n_dups: int = 2_000, contigs=SLICE_CONTIGS) -> dict:
    """bench.py's 5-step input: ``n_reads - n_dups`` reads (samgen, seed
    11) from the planted genome, soft-clipped ones realigned (see
    realign_soft_clips), then ``n_dups`` duplicate reads: copies of
    sampled pairs under Illumina qnames, the second copy of each within
    optical distance of the first (bench.py:59-71). Known sites: the
    planted SNPs, as BED through the port's bed-to-elsites. Returns
    {"sam", "sites", "n_reads"}."""
    import random

    import samgen

    from elprep_tpu_torch import cli

    lines = realign_soft_clips(samgen.reads_from_genome(
        n_reads - n_dups, contigs, ref["alt"], seed=11, rg_ids=["rg1"]))
    rng = random.Random(13)
    dups = []
    while len(dups) + 4 <= n_dups:
        idx = rng.randrange(0, len(lines) // 2) * 2
        f = lines[idx].split("\t")
        m = lines[idx + 1].split("\t")
        x, y = rng.randrange(1000, 30000), rng.randrange(1000, 30000)
        for k in range(2):
            q = (f"M01:1:FC:1:2208:{x + k * rng.randrange(0, 80)}:"
                 f"{y + k * rng.randrange(0, 80)}")
            dups.append("\t".join([q] + f[1:]))
            dups.append("\t".join([q] + m[1:]))
    sam = os.path.join(workdir, "five_step.sam")
    with open(sam, "w") as fh:
        fh.write("\n".join(_header(contigs) + lines + dups) + "\n")
    bed = os.path.join(workdir, "snps.bed")
    with open(bed, "w") as fh:
        fh.writelines(f"{name}\t{p}\t{p + 1}\n" for name, p in ref["snps"])
    sites = os.path.join(workdir, "snps.elsites")
    if cli.main(["bed-to-elsites", bed, sites]) != 0:
        raise AssertionError("bed-to-elsites failed")
    return {"sam": sam, "sites": sites, "n_reads": len(lines) + len(dups)}


# ---------------------------------------------------------------------------
# Phase 4: the three torch device programs at the slice's size
# ---------------------------------------------------------------------------


# (name, file of the port, what it replaces in the JAX package)
DEVICE_OPS = (
    ("mark_duplicates", "elprep_tpu_torch/ops/dedup.py", "elprep_tpu/ops/dedup.py:76"),
    ("recalibrate_tables", "elprep_tpu_torch/ops/bqsr_ops.py",
     "elprep_tpu/ops/bqsr_ops.py:205 (packed entry :234)"),
    ("apply_bqsr", "elprep_tpu_torch/ops/bqsr_ops.py", "elprep_tpu/ops/bqsr_ops.py:254"),
)


def _host_median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _nbytes(*arrays) -> int:
    import numpy as np

    return int(sum(np.asarray(a).nbytes for a in arrays))


def _to_cuda(*arrays):
    import numpy as np
    import torch

    return [torch.as_tensor(np.ascontiguousarray(a)).cuda() for a in arrays]


def _same(name: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: card differs from its host twin "
                             f"({bad} elements of {want.size})")


def _profile_top(name: str, fn, top: int = 6) -> dict:
    """One warm call of ``fn`` under torch.profiler: the device's busy
    time (the sum of its kernels' times), the call's wall, and the
    kernels that took the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.count, getattr(e, "self_device_time_total",
                                         getattr(e, "self_cuda_time_total", 0)) / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in kernels)
    _log("%s profile: %d kernel launches, device busy %.4f ms of %.4f ms wall "
         "(%.1f%%); top: %s" % (
             name, sum(k[1] for k in kernels), busy_ms, wall_ms,
             100.0 * busy_ms / wall_ms,
             "; ".join("%s x%d %.4f ms" % (k[0][:60], k[1], k[2]) for k in kernels[:top])))
    return {"launches": sum(k[1] for k in kernels), "busy_ms": busy_ms, "wall_ms": wall_ms}


def device_ops_phase(fx: dict, elfasta: str, max_cycle: int = 500,
                     reps: int = 10) -> dict:
    """Duplicate mask, BQSR tables and recalibrated quals of the 5-step
    fixture on the card, each bit-equal to its host twin (the numpy/native
    engines of the CPU route) on the same inputs, with the card's time
    (CUDA events, inputs already on the card), the host twin's time and
    the bytes bound. Returns {name: numbers}."""
    import numpy as np

    from elprep_tpu_torch import native
    from elprep_tpu_torch.filters import add_refid
    from elprep_tpu_torch.filters import bqsr as fb
    from elprep_tpu_torch.io import sam as samio
    from elprep_tpu_torch.io.fasta import MappedFasta, RefIndex
    from elprep_tpu_torch.ops import bqsr_ops, dedup, packed, sortkeys

    hdr, batch = samio.read_sam_file(fx["sam"])
    add_refid(hdr)(batch)
    n = len(batch)
    out = {}

    # duplicate mask: the derived columns agree between the card's
    # readstats ops and the native engine, then the mask itself
    libid, upos, score, rev = dedup.dedup_columns(batch, hdr, device="cuda")
    for a, b in zip((libid, upos, score, rev), dedup.dedup_columns(batch, hdr, device="cpu")):
        _same("dedup columns", a, b)
    cols = [np.asarray(c, np.int32) for c in (
        libid, batch.temps["REFID"], upos, rev, score, sortkeys.qname_ranks(batch.qname),
        batch.flag)]
    dcols = _to_cuda(*cols)
    got = dedup.mark_duplicates(*dcols, device="cuda")
    want = dedup.mark_duplicates_host(*cols)
    _same("mark_duplicates", got.cpu().numpy(), want)
    out["mark_duplicates"] = dict(
        rows=n, ms=_median_ms(lambda: dedup.mark_duplicates(*dcols, device="cuda"), reps),
        host_ms=_host_median_ms(lambda: dedup.mark_duplicates_host(*cols), 3),
        bytes=_nbytes(*cols) + n, note="%d duplicates" % int(want.sum()))

    # table build: one slice of the packed inputs, as the filter ships it
    recal = fb.BaseRecalibrator([fx["sites"]], RefIndex(MappedFasta(elfasta)))
    prep = fb.prep_recalibrate_columns(recal, hdr, batch, None, max_cycle)
    slices = list(fb._iter_prep_slices([prep], max_rows=1 << 17))
    if len(slices) != 1:
        raise AssertionError(f"{prep['n_real']} reads took {len(slices)} slices")
    sl = slices[0]
    classes = recal.ref.classes
    n_rg = 1
    bp, lut = packed.pack_nibble_dict(sl["base"])
    table_host = (bp, lut, sl["qual"], sl["seq_len"], sl["flag"], sl["pos"], sl["rg"],
               sl["refoff"], packed.pack_bits(sl["skip"]), sl["op_class"], sl["op_len"],
               classes)
    table_in = _to_cuda(*table_host)
    width = sl["base"].shape[1]

    def build():
        return bqsr_ops.recalibrate_tables_packed(
            *table_in, max_cycle=max_cycle, n_rg=n_rg, width=width, device="cuda")

    got = build()
    want, want_mac = native.bqsr_covariate_tables(sl, classes, max_cycle, n_rg)
    for g, w in zip(got[:6], want):
        _same("recalibrate_tables", g.cpu().numpy(), w)
    if int(got[6]) != want_mac:
        raise AssertionError(f"max |cycle| {int(got[6])} != {want_mac}")
    out["recalibrate_tables"] = dict(
        rows=int(sl["m"]), ms=_median_ms(build, reps),
        host_ms=_host_median_ms(
            lambda: native.bqsr_covariate_tables(sl, classes, max_cycle, n_rg), 3),
        bytes=_nbytes(*table_host, *want),
        note="%d real reads of %d rows, width %d" % (prep["n_real"], sl["m"], width))

    # apply: the tables just built, finalized, over the whole batch
    tables = fb.BaseRecalibratorTables.zeros(["unit1"], max_cycle)
    for key, w in zip(("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism"),
                      want):
        getattr(tables, key)[:] = w.reshape(getattr(tables, key).shape)
    tables.finalize()
    cond_prior, d_cyc, d_ctx, rg_present = fb.build_apply_tables(tables)
    _, quant = tables.quantization(0)
    sqq = np.arange(255, dtype=np.uint8)
    width = ((int(batch.qual.lengths.max()) + 31) // 32) * 32
    qual_padded, qual_len = batch.qual.to_padded(width)
    base_padded, _ = batch.seq.to_padded(width)
    apply_host = (base_padded, qual_padded, qual_len.astype(np.int32), batch.flag,
               np.zeros(n, np.int32), rg_present, cond_prior, d_cyc, d_ctx, quant, sqq)
    apply_in = _to_cuda(*apply_host)

    def apply():
        return bqsr_ops.apply_bqsr(*apply_in, max_cycle=max_cycle, device="cuda")

    newq, mac = apply()
    want_q, want_mac = native.bqsr_apply_quals(*apply_host, max_cycle)
    _same("apply_bqsr", newq.cpu().numpy(), want_q)
    if int(mac) != want_mac:
        raise AssertionError(f"apply max |cycle| {int(mac)} != {want_mac}")
    out["apply_bqsr"] = dict(
        rows=n, ms=_median_ms(apply, reps),
        host_ms=_host_median_ms(lambda: native.bqsr_apply_quals(*apply_host, max_cycle), 3),
        bytes=_nbytes(*apply_host, want_q), note="width %d" % width)

    for name, fn in (("mark_duplicates",
                      lambda: dedup.mark_duplicates(*dcols, device="cuda")),
                     ("recalibrate_tables", build), ("apply_bqsr", apply)):
        out[name]["profile"] = _profile_top(name, fn)
    for name, d in out.items():
        d["bound_ms"] = d["bytes"] / PEAK_BYTES_PER_S * 1e3
        _log("%s: %d rows (%s), bit-equal to its host twin; card %.4f ms median of "
             "%d, host twin %.2f ms median of 3, bound %.4f ms (%d bytes), %.1fx off it"
             % (name, d["rows"], d["note"], d["ms"], reps, d["host_ms"], d["bound_ms"],
                d["bytes"], d["ms"] / d["bound_ms"]))
    return out


class _ProgramCounter:
    """Counts the calls of the three torch device programs that run on
    cuda during one run, and their device time (CUDA events around each
    outermost call: the packed table build calls the dense one)."""

    def __init__(self):
        from elprep_tpu_torch.ops import bqsr_ops, dedup

        self.targets = [(dedup, "mark_duplicates", "mark_duplicates"),
                        (bqsr_ops, "recalibrate_tables_packed", "recalibrate_tables"),
                        (bqsr_ops, "recalibrate_tables", "recalibrate_tables"),
                        (bqsr_ops, "apply_bqsr", "apply_bqsr")]
        self.orig = [getattr(mod, attr) for mod, attr, _ in self.targets]
        self.calls = {name: 0 for _, _, name in self.targets}
        self.events = {name: [] for _, _, name in self.targets}
        self.depth = [0]

    @staticmethod
    def on_card(device) -> bool:
        from elprep_tpu_torch import device as _device

        return _device.resolve(device).type == "cuda"

    def __enter__(self):
        import torch

        def wrap(fn, name):
            def counted(*a, **k):
                if self.depth[0] or not self.on_card(k.get("device")):
                    return fn(*a, **k)
                self.depth[0] += 1
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                try:
                    return fn(*a, **k)
                finally:
                    e1.record()
                    self.events[name].append((e0, e1))
                    self.calls[name] += 1
                    self.depth[0] -= 1
            return counted

        for (mod, attr, name), fn in zip(self.targets, self.orig):
            setattr(mod, attr, wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.targets, self.orig):
            setattr(mod, attr, fn)
        return False

    def device_s(self, name: str) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events[name]) / 1e3


class _StderrTee:
    """Copies what a run writes to stderr (the --timed phase lines)."""

    def __enter__(self):
        import io

        self.buf = io.StringIO()
        self.orig = sys.stderr
        tee, buf = self.orig, self.buf

        class _Tee:
            def write(self, s):
                tee.write(s)
                buf.write(s)

            def flush(self):
                tee.flush()
        sys.stderr = _Tee()
        return self

    def __exit__(self, *exc):
        sys.stderr = self.orig
        return False

    def phases(self) -> list:
        """[(phase message, seconds)] from the --timed lines."""
        out, msg = [], None
        for ln in self.buf.getvalue().splitlines():
            if ln.startswith("  done in ") and msg is not None:
                out.append((msg, float(ln.split()[2].rstrip("s"))))
                msg = None
            elif not ln.startswith(" "):
                msg = ln.strip()
        return out


def _zero_pairhmm_counts():
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    pc.LAUNCHES = 0
    pc.LAUNCHES_BY_PATH.update({k: 0 for k in pc.LAUNCHES_BY_PATH})


def _pairhmm_counts(what: str) -> tuple:
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    launches, by_path = pc.LAUNCHES, dict(pc.LAUNCHES_BY_PATH)
    if launches <= 0:
        raise AssertionError(f"the {what} run launched no PairHMM kernel")
    if by_path["warp"] != launches:
        raise AssertionError(f"{what} launches off the warp path: {by_path}")
    return launches, by_path


def _gvcf_records(path: str) -> tuple:
    import gzip

    with gzip.open(path, "rb") as fh:
        vcf = fh.read()
    records = [ln for ln in vcf.split(b"\n") if ln and not ln.startswith(b"#")]
    variants = [ln for ln in records if ln.split(b"\t")[4] != b"<NON_REF>"]
    return records, variants


# ---------------------------------------------------------------------------
# Phase 5: the 5-step filter at real size, pooled and serial
# ---------------------------------------------------------------------------


class _PoolWatch:
    """Records what ``hc.parallel.get_pool`` returns during a run (the
    CLI asks for the pool before the read phase, for the table build and
    for the HaplotypeCaller)."""

    def __init__(self):
        from elprep_tpu_torch.hc import parallel

        self.parallel = parallel
        self.orig = parallel.get_pool
        self.got = []

    def __enter__(self):
        def watched(n_workers):
            pool = self.orig(n_workers)
            self.got.append((n_workers, pool))
            return pool

        self.parallel.get_pool = watched
        return self

    def __exit__(self, *exc):
        self.parallel.get_pool = self.orig
        return False

    def pools(self) -> list:
        """The pools returned to the HaplotypeCaller's requests (n > 1)."""
        return [pool for n, pool in self.got if n > 1]


def start_pool() -> dict:
    """Start the worker pool at the CLI's default size (the CPU count)
    and wait until every worker answers; the CLI runs reuse it. Returns
    {"workers", "start_s", "cpu_count"}."""
    from elprep_tpu_torch.hc import parallel

    n = os.cpu_count() or 1
    t0 = time.perf_counter()
    pool = parallel.get_pool(n)
    if pool is None:
        raise AssertionError(f"no worker pool of {n} workers")
    infos = pool.probe_workers()
    start_s = time.perf_counter() - t0
    _check_workers_off_card(pool, infos)
    _log("pool: os.cpu_count() %d, %d workers, started and answering in %.2f s"
         % (n, pool.n, start_s))
    return {"workers": pool.n, "start_s": start_s, "cpu_count": n}


def _check_workers_off_card(pool, infos=None) -> None:
    """Every worker reports the CPU as its device, no visible card and no
    CUDA context, and nvidia-smi lists no process but this one on the
    card."""
    infos = pool.probe_workers() if infos is None else infos
    for w, info in enumerate(infos):
        if (info["device"] != "cpu" or info["CUDA_VISIBLE_DEVICES"] != ""
                or info["cuda_initialized"]):
            raise AssertionError(f"pool worker {w} is not off the card: {info}")
    pids = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.split()
    workers = {str(info["pid"]) for info in infos}
    if len(pids) > 1 or workers & set(pids):
        raise AssertionError(f"processes on the card {pids}: more than this one "
                             f"(pid {os.getpid()}; workers {sorted(workers)})")
    _log("pool workers off the card: %d workers on the CPU without a CUDA "
         "context; nvidia-smi compute apps %s (this process %d)"
         % (len(infos), pids, os.getpid()))


def _run_five_step(workdir: str, fx: dict, elfasta: str, tag: str,
                   hc_workers: str = "", cold: bool = False) -> dict:
    """One 5-step run through the CLI on cuda into ``workdir/tag``, with
    the device programs' and PairHMM counts of that run and its checks.
    ``hc_workers`` sets ELPREP_TPU_HC_WORKERS ("": the CLI's default).
    ``cold``: no pool is alive before the run, so the CLI's spawn of its
    workers is inside the timed window, as in a user's single run."""
    import numpy as np

    from elprep_tpu_torch import cli
    from elprep_tpu_torch.filters import add_refid
    from elprep_tpu_torch.io import sam as samio

    od = os.path.join(workdir, tag)
    os.makedirs(od)
    out = {k: os.path.join(od, f) for k, f in (
        ("bam", "out.bam"), ("metrics", "metrics.txt"), ("recal", "out.recal"),
        ("vcf", "out.vcf.gz"))}
    args = ["filter", fx["sam"], out["bam"], "--mark-duplicates",
            "--mark-optical-duplicates", out["metrics"], "--sorting-order", "coordinate",
            "--bqsr", out["recal"], "--known-sites", fx["sites"], "--reference", elfasta,
            "--haplotypecaller", out["vcf"], "--reference-confidence", "GVCF", "--timed"]
    from elprep_tpu_torch.hc import parallel

    old = os.environ.pop("ELPREP_TPU_HC_WORKERS", None)
    if hc_workers:
        os.environ["ELPREP_TPU_HC_WORKERS"] = hc_workers
    _zero_pairhmm_counts()
    # the pool started by start_pool(), if this run uses it: its workers'
    # CPU seconds before and after say how busy they were
    pool = (parallel.get_pool(os.cpu_count() or 1)
            if not hc_workers and not cold else None)
    before = [w["cpu_s"] for w in pool.probe_workers()] if pool is not None else None
    try:
        with (_ProgramCounter() as ops, _PairHMMTimer() as tm, _StderrTee() as err,
              _PoolWatch() as pw):
            t0 = time.perf_counter()
            c0 = time.process_time()
            rc = cli.main(args)
            wall = time.perf_counter() - t0
            main_cpu_s = time.process_time() - c0
    finally:
        os.environ.pop("ELPREP_TPU_HC_WORKERS", None)
        if old is not None:
            os.environ["ELPREP_TPU_HC_WORKERS"] = old
    if rc != 0:
        raise AssertionError(f"5-step {tag} run failed: rc {rc}")
    launches, by_path = _pairhmm_counts(f"5-step {tag}")
    for name, calls in ops.calls.items():
        if calls <= 0:
            raise AssertionError(f"the 5-step {tag} run did not run {name} on the card")
    pools = pw.pools()

    n_reads = fx["n_reads"]
    hdr, batch = samio.read_sam_file(out["bam"])
    if len(batch) != n_reads or hdr.hd_so().value != "coordinate":
        raise AssertionError(f"5-step BAM: {len(batch)} records, SO {hdr.hd_so()}")
    add_refid(hdr)(batch)
    refid = batch.temps["REFID"].astype(np.int64)
    key = np.where(refid < 0, np.iinfo(np.int64).max, refid * 2**33 + batch.pos)
    if not (np.diff(key) >= 0).all():
        raise AssertionError("5-step BAM is not coordinate-sorted")
    n_dup = int(((batch.flag & 0x400) != 0).sum())
    if n_dup <= 0:
        raise AssertionError("5-step run flagged no duplicates")
    with open(out["metrics"], "rb") as fh:
        rows = [ln.split(b"\t") for ln in fh.read().split(b"\n") if ln.startswith(b"lib1\t")]
    optical = int(rows[0][7]) if len(rows) == 1 else 0
    if optical <= 0:
        raise AssertionError(f"5-step metrics show no optical duplicates: {rows}")
    report = _read(out["recal"])
    table0 = report[report.index(b"#:GATKTable:RecalTable0:"):].split(b"\n")[2]
    if not table0.startswith(b"unit1 "):
        raise AssertionError(f"recal file has no read-group row: {table0!r}")
    records, variants = _gvcf_records(out["vcf"])
    if not variants:
        raise AssertionError("5-step GVCF has no ALT calls")
    phases = err.phases()
    device_s = {name: ops.device_s(name) for name in ops.calls}
    kernel_s = tm.kernel_s()
    workers = pools[0].n if pools and pools[0] is not None else 1
    _log("5-step %s (%d HC workers): %d reads in %.2f s = %.0f reads/s; %d duplicates "
         "flagged, %d optical pairs; RecalTable0 %s; GVCF %d records (%d with an ALT "
         "besides <NON_REF>)" % (tag, workers, n_reads, wall, n_reads / wall, n_dup,
                                 optical, b" ".join(table0.split()).decode(),
                                 len(records), len(variants)))
    _log("5-step %s phases (--timed): " % tag + "; ".join("%s %.2f s" % p for p in phases))
    _log("5-step %s device programs on the card: " % tag + "; ".join(
        "%s %d calls, %.4f s device" % (k, ops.calls[k], device_s[k]) for k in ops.calls))
    hc_s = dict(phases).get("Calling variants.", wall)
    worker_cpu_s = None
    if before is not None:
        worker_cpu_s = sum(w["cpu_s"] for w in pool.probe_workers()) - sum(before)
        _log("5-step %s CPU: the %d workers %.2f s (busy %.1f%% of %d x the %.2f s "
             "HaplotypeCaller phase); this process %.2f s over its %.2f s wall, all "
             "threads" % (tag, pool.n, worker_cpu_s,
                          100.0 * worker_cpu_s / (pool.n * hc_s), pool.n, hc_s,
                          main_cpu_s, wall))
    else:
        _log("5-step %s CPU: this process %.2f s over its %.2f s wall, all threads"
             % (tag, main_cpu_s, wall))
    _log("5-step %s PairHMM: %d launches (per path %s), %d pairs, %.1f pairs per "
         "launch; %.2f s wall in the PairHMM calls (summed over dispatch threads, "
         "%.1f%% of the run): host packing %.2f s, kernel %.4f s on the device"
         % (tag, launches, json.dumps(by_path), tm.pairs, tm.pairs / launches,
            tm.total_s, 100.0 * tm.total_s / wall, tm.pack_s, kernel_s))
    return {"launches": launches, "launches_by_path": by_path, "wall_s": wall,
            "phases": phases, "calls": dict(ops.calls), "device_s": device_s,
            "pairs": tm.pairs, "kernel_s": kernel_s, "workers": workers,
            "pools": pools, "out": out, "main_cpu_s": main_cpu_s,
            "worker_cpu_s": worker_cpu_s}


def _bam_records(path: str) -> list:
    from elprep_tpu_torch.io import sam as samio

    _, batch = samio.read_sam_file(path)
    return samio.format_alignments(batch).split(b"\n")


def _metrics_body(path: str) -> bytes:
    data = _read(path)
    return data[data.index(b"## METRICS CLASS"):]


def _vcf_body(path: str) -> list:
    import gzip

    with gzip.open(path, "rb") as fh:
        return [ln for ln in fh.read().split(b"\n")
                if not ln.startswith(b"##elPrepCommandLine")]


def five_step_phase(workdir: str, fx: dict, elfasta: str) -> dict:
    """``filter --mark-duplicates --mark-optical-duplicates
    --sorting-order coordinate --bqsr --known-sites --haplotypecaller
    --reference-confidence GVCF`` (bench.py's command) through the port's
    CLI on cuda: pooled from cold (the CLI's default worker count, the
    pool's spawn inside the wall: the end-to-end number), pooled again on
    the warm pool, then serial (ELPREP_TPU_HC_WORKERS=1). The pooled runs
    got their pool, its workers stay off the card, and their BAM records,
    recal report, metrics body and GVCF body are byte-equal to the serial
    run's."""
    from elprep_tpu_torch.hc import parallel

    parallel.shutdown_pool()
    pooled = _run_five_step(workdir, fx, elfasta, "pooled", cold=True)
    pools = pooled["pools"]
    if not pools or any(p is None for p in pools):
        raise AssertionError(f"the pooled 5-step run got no worker pool: {pools}")
    _check_workers_off_card(pools[0])
    warm = _run_five_step(workdir, fx, elfasta, "pooled-warm")
    if not warm["pools"] or any(p is not pools[0] for p in warm["pools"]):
        raise AssertionError("the warm pooled 5-step run did not reuse the pool")
    serial = _run_five_step(workdir, fx, elfasta, "serial", hc_workers="1")
    if serial["pools"]:
        raise AssertionError("the serial 5-step run asked for a pool")
    so = serial["out"]
    for tag, run in (("pooled", pooled), ("pooled-warm", warm)):
        po = run["out"]
        for what, a, b in (
                ("BAM records", _bam_records(po["bam"]), _bam_records(so["bam"])),
                ("recal report", _read(po["recal"]), _read(so["recal"])),
                ("metrics body", _metrics_body(po["metrics"]), _metrics_body(so["metrics"])),
                ("GVCF body", _vcf_body(po["vcf"]), _vcf_body(so["vcf"]))):
            if a != b:
                raise AssertionError(f"5-step {tag} {what} differ from the serial run's")
    _log("5-step pooled == pooled-warm == serial: BAM records, recal report, metrics "
         "body and GVCF body byte-equal; walls %.2f s pooled from cold (%d workers, "
         "spawn included), %.2f s on the warm pool, %.2f s serial (%.2fx cold, %.2fx "
         "warm); PairHMM launches %d / %d vs %d, pairs per launch %.1f / %.1f vs %.1f"
         % (pooled["wall_s"], pooled["workers"], warm["wall_s"], serial["wall_s"],
            serial["wall_s"] / pooled["wall_s"], serial["wall_s"] / warm["wall_s"],
            pooled["launches"], warm["launches"], serial["launches"],
            pooled["pairs"] / pooled["launches"], warm["pairs"] / warm["launches"],
            serial["pairs"] / serial["launches"]))
    return {"pooled": pooled, "warm": warm, "serial": serial}


# ---------------------------------------------------------------------------
# Phase 6: sfm on the 5-step fixture, in-process on the shared pool
# ---------------------------------------------------------------------------


def sfm_phase(workdir: str, fx: dict, elfasta: str, whole: dict) -> dict:
    """``sfm`` with the 5-step options (one job at a time, in this
    process, so every contig group reuses the worker pool): the same BAM
    records (as a multiset: sfm writes the unmapped group first) and the
    same GVCF body as the whole-file pooled run ``whole``."""
    from elprep_tpu_torch import cli

    od = os.path.join(workdir, "sfm")
    os.makedirs(od)
    out_bam, out_vcf = os.path.join(od, "out.bam"), os.path.join(od, "out.vcf.gz")
    args = ["sfm", fx["sam"], out_bam, "--mark-duplicates", "--mark-optical-duplicates",
            os.path.join(od, "metrics.txt"), "--sorting-order", "coordinate",
            "--bqsr", os.path.join(od, "out.recal"), "--known-sites", fx["sites"],
            "--reference", elfasta, "--haplotypecaller", out_vcf,
            "--reference-confidence", "GVCF", "--tmp-path", os.path.join(od, "tmp"),
            "--nr-of-jobs", "1"]
    _zero_pairhmm_counts()
    with _PoolWatch() as pw:
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"sfm run failed: rc {rc}")
    launches, by_path = _pairhmm_counts("sfm")
    pools = pw.pools()
    if not pools or any(p is not pools[0] or p is None for p in pools):
        raise AssertionError("the sfm jobs did not share one worker pool")
    if sorted(_bam_records(out_bam)) != sorted(_bam_records(whole["bam"])):
        raise AssertionError("sfm BAM records differ from the whole-file run's")
    body = [ln for ln in _vcf_body(out_vcf) if not ln.startswith(b"#")]
    if body != [ln for ln in _vcf_body(whole["vcf"]) if not ln.startswith(b"#")] or not body:
        raise AssertionError("sfm GVCF body differs from the whole-file run's")
    _log("sfm: %d reads in %.2f s, %d pool requests over its jobs, one pool; BAM "
         "records (as a multiset) and GVCF body (%d records) equal the whole-file "
         "pooled run's; PairHMM %d launches (per path %s)"
         % (fx["n_reads"], wall, len(pools), len(body), launches, json.dumps(by_path)))
    return {"wall_s": wall, "launches": launches, "launches_by_path": by_path}


# ---------------------------------------------------------------------------
# Phase 7: the earlier slice (sort + HaplotypeCaller), at reduced depth
# ---------------------------------------------------------------------------


class _PairHMMTimer:
    """Wraps the PairHMM entry points for one run: host wall of the whole
    batched PairHMM, of the host packing, and the kernel's device time
    (CUDA events around each launch). The sums are taken under a lock,
    since with more than one dispatch thread
    (ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS) the calls are concurrent; the
    walls are then summed over the threads, and the event pairs of
    threads sharing the default stream overlap, so the device time is
    counted twice where two launches interleave. The default, one
    dispatch thread, has no overlap."""

    def __init__(self):
        import threading

        from elprep_tpu_torch.ops import pairhmm as ph
        from elprep_tpu_torch.ops import pairhmm_cuda as pc

        self.ph, self.pc = ph, pc
        self.orig = (ph.pairhmm_logl_pairs, pc.pack_pairs, pc.pairhmm_forward)
        self.lock = threading.Lock()
        self.total_s = 0.0
        self.pack_s = 0.0
        self.events = []
        self.pairs = 0

    def __enter__(self):
        import torch

        logl, pack, fwd = self.orig

        def logl_t(*a, **k):
            t0 = time.perf_counter()
            try:
                return logl(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.total_s += dt

        def pack_t(*a, **k):
            t0 = time.perf_counter()
            out = pack(*a, **k)
            dt = time.perf_counter() - t0
            with self.lock:
                self.pairs += out.n_pairs
                self.pack_s += dt
            return out

        def fwd_t(batch, tabs):
            if batch.device.type != "cuda":
                return fwd(batch, tabs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fwd(batch, tabs)
            e1.record()
            with self.lock:
                self.events.append((e0, e1))
            return out

        self.ph.pairhmm_logl_pairs = logl_t
        self.pc.pack_pairs = pack_t
        self.pc.pairhmm_forward = fwd_t
        return self

    def __exit__(self, *exc):
        self.ph.pairhmm_logl_pairs, self.pc.pack_pairs, self.pc.pairhmm_forward = self.orig
        return False

    def kernel_s(self) -> float:
        import torch

        if self.events:
            torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def slice_phase(workdir: str, ref: dict, n_reads: int = SLICE_READS,
                contigs=SLICE_CONTIGS) -> dict:
    """``filter --sorting-order coordinate --haplotypecaller
    --reference-confidence GVCF`` on ``n_reads`` reads."""
    from elprep_tpu_torch import cli
    from elprep_tpu_torch.io import sam as samio

    t0 = time.perf_counter()
    sam = make_slice_fixture(workdir, ref, n_reads, contigs)
    elfasta = ref["elfasta"]
    _log("slice fixture: %d reads over %d bp in %.1f s"
         % (n_reads, sum(n for _, n in contigs), time.perf_counter() - t0))
    out_bam = os.path.join(workdir, "slice.bam")
    out_vcf = os.path.join(workdir, "slice.vcf.gz")
    args = ["filter", sam, out_bam, "--sorting-order", "coordinate",
            "--reference", elfasta, "--haplotypecaller", out_vcf,
            "--reference-confidence", "GVCF", "--timed"]
    _zero_pairhmm_counts()
    with _PairHMMTimer() as tm:
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"slice run failed: rc {rc}")
    launches, by_path = _pairhmm_counts("slice")
    hdr, batch = samio.read_sam_file(out_bam)
    if len(batch) != n_reads or hdr.hd_so().value != "coordinate":
        raise AssertionError(f"slice BAM: {len(batch)} records, SO {hdr.hd_so()}")
    records, variants = _gvcf_records(out_vcf)
    if not records:
        raise AssertionError("slice VCF has no records")
    kernel_s = tm.kernel_s()
    _log("slice: %d reads in %.2f s = %.0f reads/s; BAM %d records; GVCF %d "
         "records (%d with an ALT besides <NON_REF>)"
         % (n_reads, wall, n_reads / wall, len(batch), len(records), len(variants)))
    _log("slice PairHMM: %d launches (per path %s), %d pairs; %.2f s wall in "
         "the PairHMM (%.1f%% of the run): host packing %.2f s, kernel %.4f s "
         "on the device"
         % (launches, json.dumps(by_path), tm.pairs, tm.total_s,
            100.0 * tm.total_s / wall, tm.pack_s, kernel_s))
    return {"launches": launches, "launches_by_path": by_path, "wall_s": wall,
            "pairhmm_s": tm.total_s, "pack_s": tm.pack_s, "kernel_s": kernel_s}


def dispatch_ab_phase(workdir: str, fx: dict, elfasta: str, rounds: int) -> dict:
    """The pooled 5-step run on the warm pool with 1 and 2 PairHMM
    dispatch threads in turns; per setting the walls and the "Calling
    variants" phase walls, in run order. One untimed run goes first: the
    first run in a process pays the card's first-use set-up."""
    _run_five_step(workdir, fx, elfasta, "ab-warm-up")
    walls = {"1": [], "2": []}
    hc = {"1": [], "2": []}
    for r in range(rounds):
        for n in ("1", "2") if r % 2 == 0 else ("2", "1"):
            os.environ["ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS"] = n
            try:
                run = _run_five_step(workdir, fx, elfasta, f"ab{r}-{n}")
            finally:
                os.environ.pop("ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS", None)
            walls[n].append(run["wall_s"])
            hc[n].append(dict(run["phases"]).get("Calling variants.", run["wall_s"]))
    _log("dispatch threads A/B (%d rounds): walls 1 thread %s, 2 threads %s; "
         "calling variants 1 thread %s, 2 threads %s"
         % (rounds, walls["1"], walls["2"], hc["1"], hc["2"]))
    return {"wall_s": walls, "calling_variants_s": hc}


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "elprep_tpu_torch")):
        print("error: run chip_smoke.py from a checkout of the repository "
              "(elprep_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, TESTS)
    os.environ["ELPREP_TPU_TORCH_DEVICE"] = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _log(smi)
    _log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")

    t_start = time.perf_counter()
    build_phase()
    if len(sys.argv) == 3 and sys.argv[1] == "--dispatch-ab":
        start_pool()
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            ref = make_reference(workdir)
            fx = make_five_step_fixture(workdir, ref)
            ab = dispatch_ab_phase(workdir, fx, ref["elfasta"], int(sys.argv[2]))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"dispatch_ab": ab}), flush=True)
        return 0
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--dispatch-ab ROUNDS]", file=sys.stderr)
        return 2
    kernel = kernel_phase()
    pool = start_pool()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        golden_phase(workdir)
        t0 = time.perf_counter()
        ref = make_reference(workdir)
        fx = make_five_step_fixture(workdir, ref)
        _log("5-step fixture: %d reads over %d bp, %d known sites, in %.1f s"
             % (fx["n_reads"], sum(n for _, n in SLICE_CONTIGS), len(ref["snps"]),
                time.perf_counter() - t0))
        ops = device_ops_phase(fx, ref["elfasta"])
        five = five_step_phase(workdir, fx, ref["elfasta"])
        sfm = sfm_phase(workdir, fx, ref["elfasta"], five["pooled"]["out"])
        earlier = slice_phase(workdir, ref)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"device_ops": [
        {"name": name, "route": "torch", "source": source, "replaces": replaces,
         "launches": five["pooled"]["calls"][name],
         "slice_device_s": five["pooled"]["device_s"][name],
         "ms": ops[name]["ms"], "host_ms": ops[name]["host_ms"],
         "bound_ms": ops[name]["bound_ms"], "bound_by": "bytes", "rows": ops[name]["rows"]}
        for name, source, replaces in DEVICE_OPS]}), flush=True)
    pooled, warm, serial = five["pooled"], five["warm"], five["serial"]
    kernel["launches"] = pooled["launches"]
    kernel["launches_by_path"] = pooled["launches_by_path"]
    kernel["pairs_per_launch"] = pooled["pairs"] / pooled["launches"]
    kernel["launches_warm"] = warm["launches"]
    kernel["launches_serial"] = serial["launches"]
    kernel["pairs_per_launch_serial"] = serial["pairs"] / serial["launches"]
    kernel["launches_sfm"] = sfm["launches"]
    kernel["launches_sort_hc"] = earlier["launches"]
    _log("5-step walls: pooled %.2f s from cold (%d workers of os.cpu_count() %d, "
         "spawn included; a pool alone starts and answers in %.2f s), %.2f s on the "
         "warm pool, serial %.2f s; sfm %.2f s"
         % (pooled["wall_s"], pooled["workers"], pool["cpu_count"], pool["start_s"],
            warm["wall_s"], serial["wall_s"], sfm["wall_s"]))
    _log("smoke: %.1f s wall" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
