#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elprep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
3. golden: the port's CLI on cuda reproduces
   tests/fixtures/hc_golden.expected.{vcf,gvcf} byte for byte;
4. slice: ``filter --sorting-order coordinate --haplotypecaller
   --reference-confidence GVCF`` on a 120 000-read fixture over a 2 Mb
   genome (the JAX package's end-to-end fixture shape, with planted
   SNPs), with the kernel launch counts of that run per path; every
   launch must have taken the warp path.

Prints the card (nvidia-smi name and power limit), one JSON line with
the kernels' numbers, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repository. Imports nothing of JAX and nothing of elprep_tpu.
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
SLICE_READS = 120_000
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


def golden_phase(workdir: str) -> None:
    from elprep_tpu_torch import cli

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
# Phase 4: the slice at real size
# ---------------------------------------------------------------------------


def make_slice_fixture(workdir: str, n_reads: int = SLICE_READS,
                       contigs=SLICE_CONTIGS) -> tuple:
    """The JAX package's end-to-end fixture shape (bench.py): 100 bp read
    pairs (tests/samgen.py, seed 11) over a synthetic genome (seed 7).
    The reads come from a copy of the genome with a SNP planted about
    every kilobase, so the HaplotypeCaller finds active regions to
    assemble and score. Returns (sam, elfasta)."""
    import random

    import samgen

    from elprep_tpu_torch import cli

    genome = samgen.make_genome(contigs, seed=7)
    rng = random.Random(19)
    alt = {}
    for name, ln in contigs:
        seq = bytearray(genome[name])
        for p in range(rng.randrange(500, 1500), ln, 1000):
            p += rng.randrange(-300, 300)
            if seq[p : p + 1] in (b"A", b"C", b"G", b"T"):
                seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
        alt[name] = bytes(seq)
    header = samgen.make_header_lines(
        contigs, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "unit1"}])
    lines = samgen.reads_from_genome(n_reads, contigs, alt, seed=11, rg_ids=["rg1"])
    sam = os.path.join(workdir, "slice.sam")
    with open(sam, "w") as fh:
        fh.write("\n".join(header + lines) + "\n")
    fasta = os.path.join(workdir, "slice.fasta")
    with open(fasta, "w") as fh:
        for name, _ in contigs:
            seq = genome[name].decode()
            fh.write(f">{name}\n")
            fh.write("\n".join(seq[k : k + 70] for k in range(0, len(seq), 70)) + "\n")
    elfasta = os.path.join(workdir, "slice.elfasta")
    if cli.main(["fasta-to-elfasta", fasta, elfasta]) != 0:
        raise AssertionError("fasta-to-elfasta failed")
    return sam, elfasta


class _PairHMMTimer:
    """Wraps the PairHMM entry points for one run: host wall of the whole
    batched PairHMM, of the host packing, and the kernel's device time
    (CUDA events around each launch)."""

    def __init__(self):
        from elprep_tpu_torch.ops import pairhmm as ph
        from elprep_tpu_torch.ops import pairhmm_cuda as pc

        self.ph, self.pc = ph, pc
        self.orig = (ph.pairhmm_logl_pairs, pc.pack_pairs, pc.pairhmm_forward)
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
                self.total_s += time.perf_counter() - t0

        def pack_t(*a, **k):
            t0 = time.perf_counter()
            try:
                out = pack(*a, **k)
                self.pairs += out.n_pairs
                return out
            finally:
                self.pack_s += time.perf_counter() - t0

        def fwd_t(batch, tabs):
            if batch.device.type != "cuda":
                return fwd(batch, tabs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fwd(batch, tabs)
            e1.record()
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


def slice_phase(workdir: str, n_reads: int = SLICE_READS,
                contigs=SLICE_CONTIGS) -> dict:
    import gzip

    from elprep_tpu_torch import cli
    from elprep_tpu_torch.io import sam as samio
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    t0 = time.perf_counter()
    sam, elfasta = make_slice_fixture(workdir, n_reads, contigs)
    _log("slice fixture: %d reads over %d bp in %.1f s"
         % (n_reads, sum(n for _, n in contigs), time.perf_counter() - t0))
    out_bam = os.path.join(workdir, "slice.bam")
    out_vcf = os.path.join(workdir, "slice.vcf.gz")
    args = ["filter", sam, out_bam, "--sorting-order", "coordinate",
            "--reference", elfasta, "--haplotypecaller", out_vcf,
            "--reference-confidence", "GVCF", "--timed"]
    pc.LAUNCHES = 0
    pc.LAUNCHES_BY_PATH.update({k: 0 for k in pc.LAUNCHES_BY_PATH})
    with _PairHMMTimer() as tm:
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
    launches = pc.LAUNCHES
    by_path = dict(pc.LAUNCHES_BY_PATH)
    if rc != 0:
        raise AssertionError(f"slice run failed: rc {rc}")
    if launches <= 0:
        raise AssertionError("the slice run launched no PairHMM kernel")
    if by_path["warp"] != launches:
        raise AssertionError(f"slice launches off the warp path: {by_path}")
    hdr, batch = samio.read_sam_file(out_bam)
    if len(batch) != n_reads or hdr.hd_so().value != "coordinate":
        raise AssertionError(f"slice BAM: {len(batch)} records, SO {hdr.hd_so()}")
    with gzip.open(out_vcf, "rb") as fh:
        vcf = fh.read()
    records = [ln for ln in vcf.split(b"\n") if ln and not ln.startswith(b"#")]
    variants = [ln for ln in records if ln.split(b"\t")[4] != b"<NON_REF>"]
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

    build_phase()
    kernel = kernel_phase()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        golden_phase(workdir)
        run = slice_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernel["launches"] = run["launches"]
    kernel["launches_by_path"] = run["launches_by_path"]
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
