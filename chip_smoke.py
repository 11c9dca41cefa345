#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elprep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build: compile the port's CUDA kernels from the sources in this
   checkout (csrc/*.cu, one nvcc each, started together); ptxas's
   registers, stack and spill bytes per kernel, and no spill in the
   stripe kernel;
2. kernel: the PairHMM kernels at full width, batch by batch: 8192 pairs
   of reads of 100-151 bp against haplotypes of 250-600 bp (the pooled
   dispatch size; the warp path, which the plan picks for them, and the
   stripe path forced), 8192 pairs of reads of 257-450 bp
   against haplotypes of 300-650 bp ("long_hc", what 2x300 bp reads give
   the HaplotypeCaller), 8192 pairs of short reads with one in ten of
   257-300 bp ("mixed"), and 256 pairs of reads of 300-1500 bp against
   haplotypes of 1600-2400 bp ("long_256"); the stripe path, which the
   plan picks for the last three. Each path bit
   for bit the plain PyTorch version on the card, the plan's path within
   5e-4 log10 of the f64 oracle on 64 sampled pairs, each path's time in
   turns in this run, the plain version's time and the bound; then
   bench.py's GCUPS batch ("bench_wes": 16 384 pairs of 152-base reads
   against 400-base haplotypes) on the warp path, checked the same way,
   with its time, GCUPS and bound;
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
7. sharded: the sharded library on a mesh of four cuda:0 entries at the
   5-step fixture's size (``run_sharded_sort_dedup``'s SAM equal to the
   single-device dedup + sort, ``sharded_recalibrate``'s tables equal to
   the card's single-device build, ``pairhmm_sharded`` over (cuda:0,
   cuda:0) at 8192 pairs bit-equal to the plain version), each sharded
   program's card time and bytes bound; then the 5-step command with
   ``--sharded`` in this process on the warm pool, and through ``python
   -m elprep_tpu_torch.parallel.multihost`` as a fresh process (a world
   of one on NCCL), both byte-equal to the pooled run;
8. 2x300: the 5-step command on 20 000 reads of 300 bp (10 000 pairs,
   the MiSeq v3 2x300 shape) over a 200 kb genome with a SNP every ~1 kb
   and a hypervariable stretch every ~20 kb (8-10 SNPs 25-35 bp apart),
   pooled on the warm pool and serially: every check of the 5-step runs,
   the stripe path launched, every PairHMM batch whose longest read is
   over 256 bases on it and every other on the warp path, ALT calls inside
   the stretches, pooled == serial byte for byte;
9. slice: the earlier ``filter --sorting-order coordinate
   --haplotypecaller --reference-confidence GVCF`` on 30 000 reads, its
   launches again all on the warp path;
10. graft entry: the graft entry points (elprep_tpu_torch.graft_entry).
   ``fused_device_step`` on bench.py's columns (131 072 reads x 128 over a
   2^20-base reference, on the card before timing) as one CUDA graph:
   equal to its eager plain version on the card and on the CPU, the
   packed step equal to it; the graph's and the plain version's times in
   turns, launches per call under torch.profiler, the bytes bound and the
   host-to-device bytes of the dense and packed argument lists;
   ``entry()`` on the card equal to the CPU; ``dryrun_multichip(4)`` on
   four cuda:0 entries (its gloo multi-process part on the CPU), every
   PairHMM launch on the warp path.

Prints the card (nvidia-smi name and power limit), one JSON line with
the graft-entry phase's numbers, one with the device programs' numbers (the sharded ones' launches from the
in-process ``--sharded`` run), one with the kernels' numbers (the warp
path's launches from the cold pooled 5-step run, the warm, serial, sfm
and sharded runs' beside them; the stripe path's from the pooled 2x300
run, the serial one's beside them),
and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repository. Imports nothing of JAX and nothing of elprep_tpu.
"""

from __future__ import annotations

import contextlib
import functools
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

KERNEL_PAIRS = 8192
FIVE_STEP_READS = 120_000
SLICE_READS = 30_000
SLICE_CONTIGS = [("chr1", 1_200_000), ("chr2", 800_000)]
# the 2x300 bp 5-step fixture: 300 bp read pairs (MiSeq v3 600-cycle kits)
# at about 30x over a 200 kb genome, SNPs every ~1 kb and a hypervariable
# stretch every ~20 kb
LONG_READS = 20_000
LONG_READ_LEN = 300
LONG_CONTIGS = [("chr1", 120_000), ("chr2", 80_000)]
LONG_STRETCH_EVERY = 20_000
LONG_MISMATCH_RATE = 0.005


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
        warm_s = _card_first_use()
        libs = {k: f.result() for k, f in libs.items()}
    _log("build: %.1f s wall; the card's first use beside it %.1f s"
         % (time.perf_counter() - t0, warm_s))
    reports = {name: ptxas_report(lib.build_log) for name, lib in libs.items()}
    for name, lib in libs.items():
        _log("build %s: %.1f s; ptxas per kernel: %s" % (name, lib.build_seconds, "; ".join(
            "%s %d registers, %d B stack, %d B spill stores, %d B spill loads"
            % (k, v["registers"], v["stack"], v["spill_stores"], v["spill_loads"])
            for k, v in sorted(reports[name].items()))))
    stripe = {k: v for k, v in reports["pairhmm"].items() if "stripe" in k}
    if not stripe or any(v["spill_stores"] or v["spill_loads"] for v in stripe.values()):
        raise AssertionError(f"stripe kernel instantiations spill (or ptxas reported "
                             f"none): {stripe}")
    return {"seconds": {k: lib.build_seconds for k, lib in libs.items()},
            "stripe_ptxas": stripe}


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    the ``-Xptxas -v`` lines of an nvcc build log; a kernel is named by its
    function and template arguments (pairhmm_warp_kernel<8>)."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            f = re.search(r"\d(pairhmm_(?:warp|stripe)_kernel)(?:ILi(\d+)E)?",
                          m.group(1))
            cur = (f.group(1) + ("<%s>" % f.group(2) if f.group(2) else "")
                   if f else m.group(1))
            out[cur] = {"registers": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def _card_first_use() -> float:
    """The card's first use in this process (CUDA context, module loading)
    through a small run of the torch programs of the main path and the
    PairHMM's plain version; returns its seconds."""
    import numpy as np
    import torch

    from elprep_tpu_torch.ops import dedup, sortkeys
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    t0 = time.perf_counter()
    rng = np.random.RandomState(1)
    cols = [rng.randint(0, 50, 4096).astype(np.int32) for _ in range(7)]
    dedup.mark_duplicates(*cols, device="cuda")
    sortkeys.coordinate_sort_perm(*(cols + [cols[0]]), device="cuda")
    batch = pc.pack_pairs(*make_pairs(64, seed=1)).to("cuda")
    pc.pairhmm_forward_plain(batch, pc.default_tables("cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 2: the PairHMM kernel at full width
# ---------------------------------------------------------------------------


def make_pairs(n_pairs: int, seed: int, reads_per_region: int = 8,
               haps_per_region: int = 4, read_len=(100, 151), hap_len=(250, 600)):
    """Synthetic HaplotypeCaller dispatch: regions of ``haps_per_region``
    haplotypes (``hap_len`` bp, by default 250-600, mutated copies of one
    reference window) and ``reads_per_region`` reads (``read_len`` bp, by
    default 100-151, no longer than the haplotype they are sampled from,
    with 2% errors and some 'N' bases), every read against every haplotype
    of its region. Returns (reads, haps, pair_r, pair_h)."""
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
            lr = rng.randint(read_len[0], min(read_len[1], len(src)) + 1)
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


def make_mixed_pairs(n_pairs: int, seed: int, long_share: float = 0.1):
    """A pooled dispatch of short reads with some long ones among them:
    ``long_share`` of the pairs from regions of 257-300 bp reads against
    haplotypes of 320-650 bp, the rest from regions of 100-151 bp reads
    (make_pairs), in one random order. Returns (reads, haps, pair_r,
    pair_h)."""
    import numpy as np

    n_long = int(round(n_pairs * long_share))
    sr, sh, spr, sph = make_pairs(n_pairs - n_long, seed)
    lr_, lh_, lpr, lph = make_pairs(n_long, seed + 1, read_len=(257, 300),
                                    hap_len=(320, 650))
    pair_r = np.concatenate([spr, lpr + len(sr)])
    pair_h = np.concatenate([sph, lph + len(sh)])
    order = np.random.RandomState(seed + 2).permutation(n_pairs)
    return sr + lr_, sh + lh_, pair_r[order], pair_h[order]


def make_region(n_reads: int, n_haps: int, seed: int, read_len=(100, 151),
                hap_len: int = 400):
    """One HaplotypeCaller region: ``n_haps`` haplotypes that differ from
    one reference window by a SNP each (as a region's assembled haplotypes
    do) and ``n_reads`` reads sampled from them with 1% errors and
    qualities 20-40. Returns (reads, haps)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, hap_len)
    haps = []
    for k in range(n_haps):
        h = ref.copy()
        if k:
            p = rng.randint(hap_len)
            h[p] = rng.choice(acgt[acgt != h[p]])
        haps.append(h.tobytes())
    reads = []
    for _ in range(n_reads):
        src = np.frombuffer(haps[rng.randint(n_haps)], np.uint8)
        lr = rng.randint(read_len[0], read_len[1] + 1)
        st = rng.randint(0, hap_len - lr + 1)
        seq = src[st : st + lr].copy()
        err = rng.rand(lr) < 0.01
        seq[err] = rng.choice(acgt, int(err.sum()))
        reads.append((seq.tobytes(), rng.randint(20, 41, lr).astype(np.uint8), 60))
    return reads, haps


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


def _oracle_check(name: str, got, reads, haps, pair_r, pair_h, n_sample: int,
                  seed: int) -> float:
    """Sampled pairs of a kernel's result against the f64 oracle, within
    5e-4 log10: ``n_sample`` of the pairs the pipeline keeps from f32 (log10
    >= -25); where the batch has fewer, of those whose f32 value is above
    1e-60 (a normal float with margin; the pipeline rescues them in f64).
    Returns the largest |log10 difference|."""
    import numpy as np

    from elprep_tpu_torch.ops import pairhmm as ph
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    acc = got.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        logl = np.log10(acc) - pc.F32_INITIAL_POW * np.log10(2.0)
    kept = np.flatnonzero(np.isfinite(logl) & (logl >= ph.F32_RESCUE_LOG10))
    pool, what = kept, "kept from f32"
    if len(kept) < n_sample:
        pool = np.flatnonzero(np.isfinite(logl) & (logl >= -60.0))
        what = "above 1e-60 in f32 (%d kept from f32)" % len(kept)
    rng = np.random.RandomState(seed)
    sample = rng.choice(pool, min(n_sample, len(pool)), replace=False)
    worst = 0.0
    for b in sample:
        seq, qual, mapq = reads[pair_r[b]]
        worst = max(worst, abs(logl[b] - ph.pairhmm_f64_diag(seq, qual, mapq,
                                                             haps[pair_h[b]])))
    _log("%s vs f64 oracle: %d sampled of the %d pairs %s, of %d: max |log10 diff| %.3g"
         % (name, len(sample), len(pool), what, len(logl), worst))
    if not len(sample) or worst >= 5e-4:
        raise AssertionError(f"{name}: f64 oracle check failed: {len(sample)} pairs, {worst}")
    return worst


def _time_batch(name: str, pairs: tuple, paths: tuple, plan_path: str, reps: int,
                n_sample: int, seed: int, plain_reps: int = 3) -> dict:
    """One batch on the card through each of ``paths`` (forced), each bit
    for bit the plain version; the plan must pick ``plan_path``, whose
    result is held to the f64 oracle on sampled pairs; each path's time in
    turns on these pairs (CUDA events, median of ``reps``), the plain
    version's time and the bound."""
    import torch

    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    reads, haps, pair_r, pair_h = pairs
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to("cuda")
    tabs = pc.default_tables("cuda")
    plan = pc.launch_plan(batch.max_read_len, None, batch.max_hap_len)
    if plan[0] != plan_path:
        raise AssertionError(f"{name}: planned on {plan}, not {plan_path}")
    plain = pc.pairhmm_forward_plain(batch, tabs)
    got = {p: pc._pairhmm_forward_path(batch, tabs, p) for p in paths}
    torch.cuda.synchronize()
    err = max(_check_equal("%s kernel %s, %s" % (
        p, pc.launch_plan(batch.max_read_len, p, batch.max_hap_len), name), got[p], plain)
        for p in paths)
    oracle = _oracle_check(f"{plan_path} kernel, {name}", got[plan_path], *pairs,
                           n_sample, seed)
    cells = _cells(reads, haps, pair_r, pair_h)
    ops_ms, bytes_ms = _bound_ms(batch, cells)
    bound_ms = max(ops_ms, bytes_ms)
    times = _median_ms_turns({p: functools.partial(pc._pairhmm_forward_path, batch, tabs, p)
                              for p in paths}, reps)
    plain_ms = _median_ms(lambda: pc.pairhmm_forward_plain(batch, tabs), plain_reps)
    ceiling_ms = OPS_PER_CELL * cells / PEAK_F32_OPS_NO_FMA * 1e3
    lens = [len(reads[r][1]) for r in pair_r]
    hlens = [len(haps[h]) for h in pair_h]
    out = {"pairs": batch.n_pairs, "cells": cells, "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "plain_ms": plain_ms, "max_abs_err": err, "oracle_max_log10": oracle,
           "reads": [min(lens), max(lens)], "haps": [min(hlens), max(hlens)],
           "paths": {}}
    for p, ms in times.items():
        out["paths"][p] = {"ms": ms, "gcups": cells / ms / 1e6,
                           "plan": list(pc.launch_plan(batch.max_read_len, p,
                                                       batch.max_hap_len))}
        _log("pairhmm %s on %s: %d pairs (reads %d-%d, haps %d-%d), %d cells: %.4f ms "
             "median of %d (%.2f GCUPS); bound %.4f ms (operations; bytes %.6f ms), "
             "%.1fx off it; without FMA at best %.4f ms"
             % (p, name, batch.n_pairs, min(lens), max(lens), min(hlens), max(hlens),
                cells, ms, reps, cells / ms / 1e6, ops_ms, bytes_ms, ms / bound_ms,
                ceiling_ms))
    _log("pairhmm %s: %splain version %.2f ms" % (name, "".join(
        "%s %.2fx the stripe path's time; " % (p, times["stripe"] / times[p])
        for p in paths if p != "stripe"), plain_ms))
    return out


# bench.py's PairHMM GCUPS batch (bench.py:255-282): 16 384 pairs, one read
# of 152 bases against one haplotype of 400 each, ACGT from seed 1,
# modified qualities 35, tandem-repeat lengths 1
WES_PAIRS, WES_READ_LEN, WES_HAP_LEN = 16384, 152, 400


def make_wes_batch(n_pairs: int = WES_PAIRS, lr: int = WES_READ_LEN,
                   lh: int = WES_HAP_LEN, seed: int = 1, error_rate: float = 0.02):
    """bench.py's GCUPS batch as a PairBatch on the host, packed field by
    field (the qualities and repeat lengths are given, not derived). Each
    read is cut from its haplotype with ``error_rate`` random base changes:
    bench.py draws reads independent of the haplotypes, whose likelihoods
    (log10 about -300 and below) underflow f32 to 0 under the 2^100
    scaling, so no value could be held to the f64 oracle; the work per cell
    is the same. Returns (batch, reads, haps) for the oracle."""
    import numpy as np

    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    hb = rng.choice(acgt, (n_pairs, lh))
    rb = np.stack([hb[i, st : st + lr]
                   for i, st in enumerate(rng.randint(0, lh - lr + 1, n_pairs))])
    err = rng.rand(n_pairs, lr) < error_rate
    rb[err] = rng.choice(acgt, int(err.sum()))
    idx = np.arange(n_pairs, dtype=np.int32)
    batch = pc.PairBatch.from_arrays({
        "read_bases": rb.reshape(-1), "read_quals": np.full(n_pairs * lr, 35, np.uint8),
        "read_repeats": np.ones(n_pairs * lr, np.uint8),
        "read_offsets": idx * lr, "read_lengths": np.full(n_pairs, lr, np.int32),
        "hap_bases": hb.reshape(-1), "hap_offsets": idx * lh,
        "hap_lengths": np.full(n_pairs, lh, np.int32),
        "hap_init": np.full(n_pairs, 2.0 ** pc.F32_INITIAL_POW / lh).astype(np.float32),
        "pair_read": idx, "pair_hap": idx})
    reads = [(r.tobytes(), np.full(lr, 35, np.uint8), 60) for r in rb]
    return batch, reads, [h.tobytes() for h in hb]


@contextlib.contextmanager
def _repeat_lengths_one():
    """The f64 oracle with every tandem-repeat length 1, as the WES batch
    gives the kernel (the oracle otherwise derives them from the bases)."""
    import numpy as np

    from elprep_tpu_torch.hc import tables
    from elprep_tpu_torch.ops import pairhmm as ph

    orig = ph.match_probs_for_read
    ph.match_probs_for_read = lambda bases: (
        np.full(len(bases), tables.MATCH_TO_MATCH[1]),
        np.full(len(bases), tables.MATCH_TO_INDEL[1]))
    try:
        yield
    finally:
        ph.match_probs_for_read = orig


def wes_batch(reps: int, n_sample: int, seed: int, plain_reps: int = 3) -> dict:
    """bench.py's GCUPS batch on the plan's path (warp), bit for bit the
    plain version, sampled pairs within 5e-4 log10 of the f64 oracle; its
    time (CUDA events, median of ``reps``), GCUPS, the plain version's
    time and the bound."""
    import numpy as np

    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    host, reads, haps = make_wes_batch()
    batch = host.to("cuda")
    tabs = pc.default_tables("cuda")
    plan = pc.launch_plan(batch.max_read_len, None, batch.max_hap_len)
    if plan[0] != "warp":
        raise AssertionError(f"bench_wes: planned on {plan}, not warp")
    got = pc.pairhmm_forward(batch, tabs)
    err = _check_equal("warp kernel %s, bench_wes" % (plan,), got,
                       pc.pairhmm_forward_plain(batch, tabs))
    idx = np.arange(batch.n_pairs)
    with _repeat_lengths_one():
        oracle = _oracle_check("warp kernel, bench_wes", got, reads, haps, idx, idx,
                               n_sample, seed)
    cells = batch.n_pairs * WES_READ_LEN * WES_HAP_LEN
    ops_ms, bytes_ms = _bound_ms(batch, cells)
    ms = _median_ms(lambda: pc.pairhmm_forward(batch, tabs), reps)
    plain_ms = _median_ms(lambda: pc.pairhmm_forward_plain(batch, tabs), plain_reps)
    out = {"pairs": batch.n_pairs, "cells": cells, "read_len": WES_READ_LEN,
           "hap_len": WES_HAP_LEN, "path": "warp", "plan": list(plan), "ms": ms,
           "gcups": cells / ms / 1e6, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "plain_ms": plain_ms, "max_abs_err": err, "oracle_max_log10": oracle}
    _log("pairhmm warp on bench_wes: %d pairs of %d x %d, %d cells: %.4f ms median of "
         "%d (%.2f GCUPS); bound %.4f ms (operations; bytes %.6f ms), %.1fx off it; "
         "plain version %.2f ms" % (batch.n_pairs, WES_READ_LEN, WES_HAP_LEN, cells, ms,
                                    reps, out["gcups"], ops_ms, bytes_ms,
                                    ms / out["bound_ms"], plain_ms))
    return out


# the kernel phase's batches: (name, pairs, forced paths timed in turns,
# the plan's path)
def _kernel_batches(n_pairs: int) -> list:
    return [
        ("short", lambda: make_pairs(n_pairs, seed=5), ("warp", "stripe"), "warp"),
        ("long_hc", lambda: make_pairs(n_pairs, seed=15, read_len=(257, 450),
                                       hap_len=(300, 650)), ("stripe",), "stripe"),
        ("mixed", lambda: make_mixed_pairs(n_pairs, seed=17), ("stripe",), "stripe"),
        ("long_256", lambda: make_pairs(256, seed=8, read_len=(300, 1500),
                                        hap_len=(1600, 2400)), ("stripe",), "stripe"),
    ]


def kernel_phase(n_pairs: int = KERNEL_PAIRS, reps: int = 20, n_sample: int = 64) -> dict:
    """The PairHMM kernels at full width, one batch after the other
    (_kernel_batches): the pooled dispatch size of short reads (the warp
    path's; the stripe path forced beside it), of the long reads
    2x300 bp data gives the HaplotypeCaller ("long_hc", reads 257-450 bp,
    haplotypes 300-650 bp), of short reads with one pair in ten long
    ("mixed"), and 256 pairs of reads of 300-1500 bp against haplotypes of
    1600-2400 bp ("long_256"); each path bit for bit the plain version, the
    plan's path against the f64 oracle, the paths timed in turns; then
    bench.py's GCUPS batch (wes_batch). Returns the kernels line's
    entries: the warp path on the short batch (with "bench_wes"), the
    stripe path on "long_hc", each with its batches."""
    batches = {}
    for k, (name, make, paths, plan_path) in enumerate(_kernel_batches(n_pairs)):
        batches[name] = _time_batch(name, make(), paths, plan_path, reps, n_sample,
                                    seed=6 + k)
    common = {"route": "cuda", "source": "elprep_tpu_torch/csrc/pairhmm.cu",
              "replaces": "elprep_tpu/ops/pairhmm_pallas.py:39", "library_ms": None}
    short, long_hc = batches["short"], batches["long_hc"]
    wes = wes_batch(reps, n_sample, seed=6 + len(batches))
    warp = dict(common, name="pairhmm_forward", ms=short["paths"]["warp"]["ms"],
                max_abs_err=max(short["max_abs_err"], wes["max_abs_err"]),
                plain_ms=short["plain_ms"],
                bound_ms=short["bound_ms"], bound_by=short["bound_by"],
                cells=short["cells"], pairs=short["pairs"], paths=short["paths"],
                bench_wes=wes)
    stripe = dict(common, name="pairhmm_forward_stripe",
                  ms=long_hc["paths"]["stripe"]["ms"],
                  max_abs_err=max(b["max_abs_err"] for b in batches.values()),
                  plain_ms=long_hc["plain_ms"], bound_ms=long_hc["bound_ms"],
                  bound_by=long_hc["bound_by"], cells=long_hc["cells"],
                  pairs=long_hc["pairs"],
                  batches={k: v for k, v in batches.items() if k != "short"})
    return {"warp": warp, "stripe": stripe}


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


def make_reference(workdir: str, contigs=SLICE_CONTIGS, stretch_every: int = 0,
                   name: str = "slice", snps_every_kb: bool = True,
                   stretch_snps=(8, 10), stretch_gap=(25, 35)) -> dict:
    """The synthetic genome of bench.py (seed 7) as .elfasta, and a copy of
    it with a SNP planted about every kilobase (unless ``snps_every_kb`` is
    false), from which the reads are sampled, so the HaplotypeCaller finds
    active regions to assemble and score. With ``stretch_every``, also a
    hypervariable stretch about every ``stretch_every`` bases (seed 23):
    ``stretch_snps`` SNPs (8-10) ``stretch_gap`` bp apart (25-35) spanning
    218-232 bp, with no other planted SNP within 200 bp of it. Such a
    stretch fills one active region (the activity reaches about 37 bp past
    its first and last SNP, and a region holds at most 300 bp), whose
    trimmed span plus its 20-base padding then exceeds 256 bases: a 300 bp
    read over it reaches the PairHMM longer than 256 bases. Returns {"alt",
    "snps" [(contig, 0-based pos)], "stretches" [(contig, first, last
    0-based pos)], "elfasta"}."""
    import random

    import samgen

    from elprep_tpu_torch import cli

    genome = samgen.make_genome(contigs, seed=7)
    rng = random.Random(19)
    alt, snps, stretches = {}, [], []
    for cname, ln in contigs:
        seq = bytearray(genome[cname])
        for p in range(rng.randrange(500, 1500), ln if snps_every_kb else 0, 1000):
            p += rng.randrange(-300, 300)
            if seq[p : p + 1] in (b"A", b"C", b"G", b"T"):
                seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
                snps.append((cname, p))
        alt[cname] = bytes(seq)
    if stretch_every:
        srng = random.Random(23)
        for cname, ln in contigs:
            seq = bytearray(alt[cname])
            for k in range(stretch_every // 2, ln - 1000, stretch_every):
                first = k + srng.randrange(-stretch_every // 8, stretch_every // 8)
                gaps = []
                while not 218 <= sum(gaps) <= 232:
                    gaps = [srng.randint(*stretch_gap)
                            for _ in range(srng.randint(*stretch_snps) - 1)]
                pos = [first + sum(gaps[:g]) for g in range(len(gaps) + 1)]
                lo, hi = pos[0] - 200, pos[-1] + 200
                for c, p in [s for s in snps if s[0] == cname and lo <= s[1] <= hi]:
                    seq[p] = genome[cname][p]
                    snps.remove((c, p))
                for p in pos:
                    if seq[p : p + 1] in (b"A", b"C", b"G", b"T"):
                        seq[p] = ord(srng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
                        snps.append((cname, p))
                stretches.append((cname, pos[0], pos[-1]))
            alt[cname] = bytes(seq)
        snps.sort(key=lambda s: ([c for c, _ in contigs].index(s[0]), s[1]))
    fasta = os.path.join(workdir, f"{name}.fasta")
    with open(fasta, "w") as fh:
        for cname, _ in contigs:
            seq = genome[cname].decode()
            fh.write(f">{cname}\n")
            fh.write("\n".join(seq[k : k + 70] for k in range(0, len(seq), 70)) + "\n")
    elfasta = os.path.join(workdir, f"{name}.elfasta")
    if cli.main(["fasta-to-elfasta", fasta, elfasta]) != 0:
        raise AssertionError("fasta-to-elfasta failed")
    return {"alt": alt, "snps": snps, "stretches": stretches, "elfasta": elfasta}


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
                           n_dups: int = 2_000, contigs=SLICE_CONTIGS,
                           read_len: int = 100, name: str = "five_step",
                           mismatch_rate: float = 0.02) -> dict:
    """bench.py's 5-step input: ``n_reads - n_dups`` reads of ``read_len``
    bases (samgen, seed 11, ``mismatch_rate`` random base changes) from the
    planted genome, soft-clipped ones realigned (see realign_soft_clips),
    then ``n_dups`` duplicate reads: copies of sampled pairs under Illumina
    qnames, the second copy of each within optical distance of the first
    (bench.py:59-71). Known sites: the planted SNPs, as BED through the
    port's bed-to-elsites. Returns {"sam", "sites", "n_reads"}."""
    import random

    import samgen

    from elprep_tpu_torch import cli

    lines = realign_soft_clips(samgen.reads_from_genome(
        n_reads - n_dups, contigs, ref["alt"], seed=11, read_len=read_len,
        rg_ids=["rg1"], mismatch_rate=mismatch_rate))
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
    sam = os.path.join(workdir, f"{name}.sam")
    with open(sam, "w") as fh:
        fh.write("\n".join(_header(contigs) + lines + dups) + "\n")
    bed = os.path.join(workdir, f"{name}.snps.bed")
    with open(bed, "w") as fh:
        fh.writelines(f"{cname}\t{p}\t{p + 1}\n" for cname, p in ref["snps"])
    sites = os.path.join(workdir, f"{name}.snps.elsites")
    if cli.main(["bed-to-elsites", bed, sites]) != 0:
        raise AssertionError("bed-to-elsites failed")
    return {"sam": sam, "sites": sites, "n_reads": len(lines) + len(dups)}


def make_long_read_fixture(workdir: str, n_reads: int = LONG_READS,
                           contigs=LONG_CONTIGS, stretch_every: int = LONG_STRETCH_EVERY,
                           **reference_options) -> tuple:
    """The 2x300 bp 5-step input: a genome with SNPs every ~1 kb and a
    hypervariable stretch every ``stretch_every`` bases (make_reference),
    ``n_reads`` reads of 300 bp with 0.5% random base changes (samgen, the
    soft-clipped ones realigned), 2% of them duplicates under Illumina
    qnames; known sites = the planted SNPs. ``reference_options``: more of
    make_reference's options. Returns (ref, fx)."""
    ref = make_reference(workdir, contigs, stretch_every=stretch_every, name="long",
                         **reference_options)
    fx = make_five_step_fixture(workdir, ref, n_reads, n_reads // 50, contigs,
                                read_len=LONG_READ_LEN, name="long",
                                mismatch_rate=LONG_MISMATCH_RATE)
    return ref, fx


def _make_fixtures(workdir: str) -> tuple:
    """The reference, the 5-step fixture, the slice's SAM and the 2x300 bp
    fixture, in a spawned process (off the card) that runs beside the
    kernel, pool and golden phases. Returns (ref, fx, slice SAM path,
    (long ref, long fx), seconds)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    for path in (REPO, TESTS):
        if path not in sys.path:
            sys.path.insert(0, path)
    t0 = time.perf_counter()
    ref = make_reference(workdir)
    fx = make_five_step_fixture(workdir, ref)
    slice_sam = make_slice_fixture(workdir, ref, SLICE_READS)
    long = make_long_read_fixture(workdir)
    return ref, fx, slice_sam, long, time.perf_counter() - t0


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
    """Counts the calls of the three torch device programs (or, with
    ``sharded``, of the two sharded programs) that run on cuda during one
    run, and their device time (CUDA events around each outermost call:
    the packed table build calls the dense one)."""

    def __init__(self, sharded: bool = False):
        from elprep_tpu_torch.ops import bqsr_ops, dedup
        from elprep_tpu_torch.parallel import sharded as psh

        self.targets = ([(psh, "sharded_sort_dedup_step", "sharded_sort_dedup_step"),
                         (psh, "_sharded_recal_step", "sharded_recal_step")]
                        if sharded else
                        [(dedup, "mark_duplicates", "mark_duplicates"),
                         (bqsr_ops, "recalibrate_tables_packed", "recalibrate_tables"),
                         (bqsr_ops, "recalibrate_tables", "recalibrate_tables"),
                         (bqsr_ops, "apply_bqsr", "apply_bqsr")])
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
        return _timed_phases(self.buf.getvalue())


def _timed_phases(text: str) -> list:
    """[(phase message, seconds)] from the --timed lines of ``text``."""
    out, msg = [], None
    for ln in text.splitlines():
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


def _long_read_counts(what: str, tm) -> tuple:
    """The launch counts of a run on long reads: the stripe path launched,
    each launch whose batch's longest read is over 256 bases (``tm``'s
    record of every launch) on it, every other on the warp path."""
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    launches, by_path = pc.LAUNCHES, dict(pc.LAUNCHES_BY_PATH)
    n_long = sum(n > pc.WARP_MAX_READ_LEN for n in tm.longest)
    if launches != len(tm.longest) or by_path["stripe"] <= 0:
        raise AssertionError(f"the {what} run: {launches} launches ({by_path}) for "
                             f"{len(tm.longest)} batches; the stripe path must launch")
    if by_path != {"warp": launches - n_long, "stripe": n_long}:
        raise AssertionError(f"the {what} run: {n_long} batches with a read over "
                             f"{pc.WARP_MAX_READ_LEN} bases, launches per path {by_path}")
    return launches, by_path


def _pairhmm_counts(what: str) -> tuple:
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    launches, by_path = pc.LAUNCHES, dict(pc.LAUNCHES_BY_PATH)
    if launches <= 0:
        raise AssertionError(f"the {what} run launched no PairHMM kernel")
    if by_path["warp"] != launches:
        raise AssertionError(f"{what} launches off the warp path: {by_path}")
    return launches, by_path


@functools.lru_cache(maxsize=None)
def _gz_lines(path: str) -> tuple:
    """The lines of a gzip-compressed output, read once per path."""
    import gzip

    with gzip.open(path, "rb") as fh:
        return tuple(fh.read().split(b"\n"))


def _gvcf_records(path: str) -> tuple:
    records = [ln for ln in _gz_lines(path) if ln and not ln.startswith(b"#")]
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


def _five_step_args(fx: dict, elfasta: str, out: dict) -> list:
    """bench.py's 5-step command (filter ... --timed) into ``out``'s paths."""
    return ["filter", fx["sam"], out["bam"], "--mark-duplicates",
            "--mark-optical-duplicates", out["metrics"], "--sorting-order", "coordinate",
            "--bqsr", out["recal"], "--known-sites", fx["sites"], "--reference", elfasta,
            "--haplotypecaller", out["vcf"], "--reference-confidence", "GVCF", "--timed"]


def _out_paths(od: str) -> dict:
    os.makedirs(od)
    return {k: os.path.join(od, f) for k, f in (
        ("bam", "out.bam"), ("metrics", "metrics.txt"), ("recal", "out.recal"),
        ("vcf", "out.vcf.gz"))}


def _run_five_step(workdir: str, fx: dict, elfasta: str, tag: str,
                   hc_workers: str = "", cold: bool = False,
                   sharded: bool = False, long_reads: bool = False) -> dict:
    """One 5-step run through the CLI on cuda into ``workdir/tag``, with
    the device programs' and PairHMM counts of that run and its checks.
    ``hc_workers`` sets ELPREP_TPU_HC_WORKERS ("": the CLI's default).
    ``cold``: no pool is alive before the run, so the CLI's spawn of its
    workers is inside the timed window, as in a user's single run.
    ``sharded``: with ``--sharded``, the two sharded programs counted too.
    ``long_reads``: the PairHMM launches need not all be on the warp path:
    every launch whose longest read is over 256 bases must be on the stripe
    path, every other on the warp path, and the stripe path launched."""
    import numpy as np

    from elprep_tpu_torch import cli
    from elprep_tpu_torch.filters import add_refid
    from elprep_tpu_torch.io import sam as samio

    out = _out_paths(os.path.join(workdir, tag))
    args = _five_step_args(fx, elfasta, out) + (["--sharded"] if sharded else [])
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
        with (_ProgramCounter() as ops,
              _ProgramCounter(sharded=True) if sharded else contextlib.nullcontext() as sops,
              _PairHMMTimer() as tm, _StderrTee() as err, _PoolWatch() as pw):
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
    launches, by_path = (_long_read_counts(f"5-step {tag}", tm) if long_reads
                         else _pairhmm_counts(f"5-step {tag}"))
    counted = [ops, sops] if sharded else [ops]
    for name, calls in [kv for c in counted for kv in c.calls.items()]:
        if calls <= 0:
            raise AssertionError(f"the 5-step {tag} run did not run {name} on the card")
    pools = pw.pools()

    n_reads = fx["n_reads"]
    hdr, batch = samio.read_sam_file(out["bam"])
    if len(batch) != n_reads or hdr.hd_so().value != "coordinate":
        raise AssertionError(f"5-step BAM: {len(batch)} records, SO {hdr.hd_so()}")
    _bam_records(out["bam"], batch)
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
    device_s = {name: c.device_s(name) for c in counted for name in c.calls}
    calls = {name: n for c in counted for name, n in c.calls.items()}
    kernel_s = tm.kernel_s()
    workers = pools[0].n if pools and pools[0] is not None else 1
    _log("5-step %s (%d HC workers): %d reads in %.2f s = %.0f reads/s; %d duplicates "
         "flagged, %d optical pairs; RecalTable0 %s; GVCF %d records (%d with an ALT "
         "besides <NON_REF>)" % (tag, workers, n_reads, wall, n_reads / wall, n_dup,
                                 optical, b" ".join(table0.split()).decode(),
                                 len(records), len(variants)))
    _log("5-step %s phases (--timed): " % tag + "; ".join("%s %.2f s" % p for p in phases))
    _log("5-step %s device programs on the card: " % tag + "; ".join(
        "%s %d calls, %.4f s device" % (k, calls[k], device_s[k]) for k in calls))
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
         "launch; %.2f s wall in the PairHMM calls (%.1f%% of the run): host "
         "packing %.2f s, kernel %.4f s on the device"
         % (tag, launches, json.dumps(by_path), tm.pairs, tm.pairs / launches,
            tm.total_s, 100.0 * tm.total_s / wall, tm.pack_s, kernel_s))
    return {"launches": launches, "launches_by_path": by_path, "wall_s": wall,
            "phases": phases, "calls": calls, "device_s": device_s,
            "pairs": tm.pairs, "kernel_s": kernel_s, "workers": workers,
            "pools": pools, "out": out, "main_cpu_s": main_cpu_s,
            "worker_cpu_s": worker_cpu_s, "longest_reads": list(tm.longest)}


# formatted records of the BAMs read so far, by path
_BAM_RECORDS: dict = {}


def _bam_records(path: str, batch=None) -> list:
    """The formatted records of a BAM (of ``batch``, when the caller has
    already read it), formatted once per path."""
    from elprep_tpu_torch.io import sam as samio

    if path not in _BAM_RECORDS:
        if batch is None:
            _, batch = samio.read_sam_file(path)
        _BAM_RECORDS[path] = samio.format_alignments(batch).split(b"\n")
    return _BAM_RECORDS[path]


def _metrics_body(path: str) -> bytes:
    data = _read(path)
    return data[data.index(b"## METRICS CLASS"):]


def _vcf_body(path: str) -> list:
    return [ln for ln in _gz_lines(path) if not ln.startswith(b"##elPrepCommandLine")]


def _same_outputs(what: str, out: dict, other: str, want: dict) -> None:
    """The BAM records, recal report, metrics body and GVCF body of two
    5-step runs are byte-equal."""
    for name, a, b in (
            ("BAM records", _bam_records(out["bam"]), _bam_records(want["bam"])),
            ("recal report", _read(out["recal"]), _read(want["recal"])),
            ("metrics body", _metrics_body(out["metrics"]), _metrics_body(want["metrics"])),
            ("GVCF body", _vcf_body(out["vcf"]), _vcf_body(want["vcf"]))):
        if a != b:
            raise AssertionError(f"{what} {name} differ from the {other} run's")


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
    for tag, run in (("pooled", pooled), ("pooled-warm", warm)):
        _same_outputs(f"5-step {tag}", run["out"], "serial", serial["out"])
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
# Phase 7: --sharded: the library on a 4-entry mesh of the one card, the CLI
# in-process and through the multi-process runner (a world of one on NCCL)
# ---------------------------------------------------------------------------

SHARDED_MESH_ENTRIES = 4

# (name, file of the port, what it replaces in the JAX package)
SHARDED_OPS = (
    ("sharded_sort_dedup_step", "elprep_tpu_torch/parallel/sharded.py",
     "elprep_tpu/parallel/sharded.py:163"),
    ("sharded_recal_step", "elprep_tpu_torch/parallel/sharded.py",
     "elprep_tpu/parallel/sharded.py:306"),
)


class _Capture:
    """Records the arguments of every call of ``mod.attr`` in a block."""

    def __init__(self, mod, attr):
        self.mod, self.attr, self.orig, self.calls = mod, attr, getattr(mod, attr), []

    def __enter__(self):
        def grab(*a):
            self.calls.append(a)
            return self.orig(*a)

        setattr(self.mod, self.attr, grab)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.orig)
        return False


def sharded_library_phase(fx: dict, elfasta: str, max_cycle: int = 500,
                          reps: int = 5) -> dict:
    """The sharded library on a mesh of SHARDED_MESH_ENTRIES entries of
    cuda:0 (the helper copies and cross-shard pairs run on the card) at
    the 5-step fixture's 120 000 reads: ``run_sharded_sort_dedup`` gives
    the SAM of the single-device dedup + sort; ``sharded_recalibrate`` the
    tables of the card's single-device build, bit for bit; then
    ``pairhmm_sharded`` over (cuda:0, cuda:0) at 8192 pairs against the
    plain version on the card. Each sharded program's card time (CUDA
    events, its host columns' copies to the card included) and bytes
    bound. Returns {name: numbers}."""
    import numpy as np
    import torch

    from elprep_tpu_torch.core.header import SortingOrder
    from elprep_tpu_torch.core.pipeline import SamData, run_pipeline
    from elprep_tpu_torch.filters import add_refid
    from elprep_tpu_torch.filters import bqsr as fb
    from elprep_tpu_torch.filters.markdup import MarkDuplicatesState, mark_duplicates_filter
    from elprep_tpu_torch.io import sam as samio
    from elprep_tpu_torch.io.fasta import MappedFasta, RefIndex
    from elprep_tpu_torch.ops import packed
    from elprep_tpu_torch.ops import pairhmm as ph
    from elprep_tpu_torch.ops import pairhmm_cuda as pc
    from elprep_tpu_torch.parallel import pairhmm_sharded
    from elprep_tpu_torch.parallel import sharded as psh

    cuda = torch.device("cuda", 0)
    mesh = (cuda,) * SHARDED_MESH_ENTRIES
    out = {}

    hdr, batch = samio.read_sam_file(fx["sam"])
    whole = run_pipeline(SamData(hdr, batch), [add_refid, mark_duplicates_filter(
        state=MarkDuplicatesState(), device=cuda)], SortingOrder.COORDINATE, device=cuda)
    shdr, sbatch = samio.read_sam_file(fx["sam"])
    add_refid(shdr)(sbatch)
    with _Capture(psh, "sharded_sort_dedup_step") as cap:
        t0 = time.perf_counter()
        got, _ = psh.run_sharded_sort_dedup(sbatch, shdr, mesh)
        wall = time.perf_counter() - t0
    shdr.set_hd_so(SortingOrder.COORDINATE)
    if samio.format_sam(shdr, got) != samio.format_sam(whole.header, whole.batch):
        raise AssertionError("run_sharded_sort_dedup differs from the single-device "
                             "dedup + sort")
    cols = cap.calls[0][1:]
    n_rows = len(cols[0])
    out["sharded_sort_dedup_step"] = dict(
        rows=n_rows, wall_s=wall,
        ms=_median_ms(lambda: cap.orig(mesh, *cols), reps),
        bytes=_nbytes(*cols) + n_rows * (1 + 8),  # dup (bool) + perm (int64) out
        note="%d shards of %d rows, %d duplicates" % (
            len(mesh), n_rows // len(mesh), int(((got.flag & 0x400) != 0).sum())))

    recal = fb.BaseRecalibrator([fx["sites"]], RefIndex(MappedFasta(elfasta)))
    single = recal.recalibrate(shdr, got, max_cycle, device=cuda)
    timings = {}
    with _Capture(psh, "_sharded_recal_step") as cap:
        tables = psh.sharded_recalibrate(recal, shdr, got, max_cycle, mesh, timings)
    for key in ("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism"):
        if not np.array_equal(getattr(tables, key), getattr(single, key)):
            raise AssertionError(f"sharded_recalibrate {key} differs from the card's "
                                 "single-device build")
    shipped = []
    for prep, classes, _, n_rg, _ in cap.calls:
        bp, lut = packed.pack_nibble_dict(prep["base"])
        shipped += [bp, lut, classes, packed.pack_bits(prep["skip"])] + [
            prep[k] for k in ("qual", "seq_len", "flag", "pos", "rg", "refoff",
                              "op_class", "op_len")]
    table_bytes = sum(getattr(single, k).size for k in (
        "qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs", "ctx_mism")) * 4
    out["sharded_recal_step"] = dict(
        rows=sum(int(c[0]["m"]) for c in cap.calls), wall_s=sum(timings.values()),
        ms=_median_ms(lambda: [cap.orig(*c) for c in cap.calls], reps),
        bytes=_nbytes(*shipped) + table_bytes * len(cap.calls),
        note="%d shards with reads; prep %.3f s, device %.3f s" % (
            len(cap.calls), timings["prep_s"], timings["device_s"]))
    for name, d in out.items():
        d["bound_ms"] = d["bytes"] / PEAK_BYTES_PER_S * 1e3
        _log("%s on %d x cuda:0: %d rows (%s), equal to the single-device result; "
             "card %.4f ms median of %d (host columns copied in), bound %.4f ms "
             "(%d bytes), %.1fx off it; %.3f s in the library call"
             % (name, len(mesh), d["rows"], d["note"], d["ms"], reps, d["bound_ms"],
                d["bytes"], d["ms"] / d["bound_ms"], d["wall_s"]))

    # PairHMM: one region's reads x haplotypes, 8192 pairs over two entries
    reads, haps = make_region(128, KERNEL_PAIRS // 128, seed=9)
    n0 = pc.LAUNCHES
    t0 = time.perf_counter()
    got = pairhmm_sharded((cuda, cuda), reads, haps).reshape(-1)
    pwall = time.perf_counter() - t0
    if pc.LAUNCHES - n0 != 2:
        raise AssertionError(f"pairhmm_sharded made {pc.LAUNCHES - n0} launches, not 2")
    pair_r = np.repeat(np.arange(len(reads)), len(haps))
    pair_h = np.tile(np.arange(len(haps)), len(reads))
    batch = pc.pack_pairs(reads, haps, pair_r, pair_h).to(cuda)
    plain = pc.pairhmm_forward_plain(batch, pc.default_tables(cuda)).cpu().numpy()
    with np.errstate(divide="ignore"):
        want = np.log10(plain.astype(np.float64)) - pc.F32_INITIAL_POW * np.log10(2.0)
    kept = np.isfinite(want) & (want >= ph.F32_RESCUE_LOG10)
    if len(got) != KERNEL_PAIRS or not np.array_equal(got[kept], want[kept]) \
            or not np.isfinite(got).all():
        raise AssertionError("pairhmm_sharded differs from the plain version")
    _log("pairhmm_sharded on (cuda:0, cuda:0): %d reads x %d haplotypes = %d pairs in "
         "2 launches, bit-equal to the plain version on the %d pairs kept from f32 "
         "(%d rescued in f64); %.3f s wall" % (len(reads), len(haps), len(got),
                                               int(kept.sum()), int((~kept).sum()), pwall))
    return out


def _multihost_run(workdir: str, fx: dict, elfasta: str, timeout_s: int = 600) -> dict:
    """The 5-step command through ``python -m
    elprep_tpu_torch.parallel.multihost`` as a fresh process: a world of
    one on NCCL (the machine has one card). Returns its outputs, wall,
    --timed phases and the runner's line (backend, collectives)."""
    import socket

    out = _out_paths(os.path.join(workdir, "multihost"))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, ELPREP_TPU_TORCH_DEVICE="cuda",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "elprep_tpu_torch.parallel.multihost",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
           "--process-id", "0", "--"] + _five_step_args(fx, elfasta, out) + ["--sharded"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout_s)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"multihost run failed: rc {proc.returncode}\n"
                             + proc.stderr[-4000:])
    runner = [ln for ln in proc.stderr.splitlines()
              if ln.startswith("elprep_tpu_torch multihost:")]
    if not runner or "rank 0 of 1 on nccl" not in runner[-1]:
        raise AssertionError(f"multihost run: no NCCL rank line: {runner}")
    return {"out": out, "wall_s": wall, "phases": _timed_phases(proc.stderr),
            "runner": runner[-1]}


def sharded_phase(workdir: str, fx: dict, elfasta: str, pooled: dict) -> dict:
    """``--sharded``: the library on the card (sharded_library_phase);
    then the 5-step command with ``--sharded`` in this process on the warm
    pool (mesh (cuda:0,)) and through the multi-process runner as a fresh
    process, each byte-equal to the pooled run ``pooled``, the in-process
    run's PairHMM launches all on the warp path."""
    lib = sharded_library_phase(fx, elfasta)
    run = _run_five_step(workdir, fx, elfasta, "sharded", sharded=True)
    _same_outputs("5-step --sharded", run["out"], "pooled", pooled["out"])
    mh = _multihost_run(workdir, fx, elfasta)
    _same_outputs("multihost 5-step --sharded", mh["out"], "pooled", pooled["out"])
    _log("5-step --sharded == pooled: BAM records, recal report, metrics body and "
         "GVCF body byte-equal, in-process (%.2f s on the warm pool, PairHMM %d "
         "launches, per path %s; sharded programs %s) and through the multi-process "
         "runner (%.2f s from a fresh process, phases %s; %s)"
         % (run["wall_s"], run["launches"], json.dumps(run["launches_by_path"]),
            {k: run["calls"][k] for k, _, _ in SHARDED_OPS}, mh["wall_s"],
            "; ".join("%s %.2f s" % p for p in mh["phases"]), mh["runner"]))
    return {"library": lib, "run": run, "multihost": mh}


# ---------------------------------------------------------------------------
# Phase 8: 2x300 bp reads through the 5-step command: the stripe path's run
# ---------------------------------------------------------------------------


def _stretch_calls(vcf: str, stretches: list) -> list:
    """ALT calls (records with an ALT besides <NON_REF>) inside each
    hypervariable stretch [first, last] (0-based) of a GVCF."""
    _, variants = _gvcf_records(vcf)
    calls = [(v.split(b"\t")[0].decode(), int(v.split(b"\t")[1]) - 1) for v in variants]
    return [sum(1 for c, p in calls if c == contig and first <= p <= last)
            for contig, first, last in stretches]


def long_read_phase(workdir: str, ref: dict, fx: dict) -> dict:
    """bench.py's 5-step command on 2x300 bp reads (make_long_read_fixture)
    through the port's CLI on cuda, pooled on the warm pool and serially:
    every check of the 5-step runs, with the PairHMM's launches on the
    stripe path for every batch whose longest read is over 256 bases and on
    the warp path for the others, the stripe path launched, ALT calls
    inside the hypervariable stretches, and the pooled outputs byte-equal
    to the serial run's."""
    pooled = _run_five_step(workdir, fx, ref["elfasta"], "2x300-pooled", long_reads=True)
    serial = _run_five_step(workdir, fx, ref["elfasta"], "2x300-serial", hc_workers="1",
                            long_reads=True)
    _same_outputs("2x300 5-step pooled", pooled["out"], "serial", serial["out"])
    inside = _stretch_calls(pooled["out"]["vcf"], ref["stretches"])
    if not any(inside):
        raise AssertionError(f"2x300: no ALT call inside the {len(inside)} stretches")
    for tag, run in (("pooled", pooled), ("serial", serial)):
        longest = run["longest_reads"]
        _log("2x300 %s: %d reads of %d bp in %.2f s = %.0f reads/s; PairHMM %d launches "
             "(per path %s), %.1f pairs per launch, longest read at the PairHMM %d "
             "bases, %d batches with a read over 256 bases"
             % (tag, fx["n_reads"], LONG_READ_LEN, run["wall_s"], fx["n_reads"] / run["wall_s"],
                run["launches"], json.dumps(run["launches_by_path"]),
                run["pairs"] / run["launches"], max(longest),
                sum(n > 256 for n in longest)))
    _log("2x300 pooled == serial: BAM records, recal report, metrics body and GVCF body "
         "byte-equal; ALT calls inside the %d hypervariable stretches: %s"
         % (len(inside), inside))
    return {"pooled": pooled, "serial": serial, "stretch_calls": inside}


# ---------------------------------------------------------------------------
# Phase 9: the earlier slice (sort + HaplotypeCaller), at reduced depth
# ---------------------------------------------------------------------------


class _PairHMMTimer:
    """Wraps the PairHMM entry points for one run: host wall of the whole
    batched PairHMM, of the host packing, and the kernel's device time
    (CUDA events around each launch). The calls come from one thread at a
    time (the pool's dispatch thread, or the serial driver's), so their
    walls and event pairs do not overlap."""

    def __init__(self):
        from elprep_tpu_torch.ops import pairhmm as ph
        from elprep_tpu_torch.ops import pairhmm_cuda as pc

        self.ph, self.pc = ph, pc
        self.orig = (ph.pairhmm_logl_pairs, pc.pack_pairs, pc.pairhmm_forward)
        self.total_s = 0.0
        self.pack_s = 0.0
        self.events = []
        self.pairs = 0
        self.longest = []  # the longest read of each batch launched on the card

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
            out = pack(*a, **k)
            self.pack_s += time.perf_counter() - t0
            self.pairs += out.n_pairs
            return out

        def fwd_t(batch, tabs):
            if batch.device.type != "cuda":
                return fwd(batch, tabs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fwd(batch, tabs)
            e1.record()
            self.events.append((e0, e1))
            self.longest.append(batch.max_read_len)
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


def slice_phase(workdir: str, ref: dict, sam: str, n_reads: int = SLICE_READS) -> dict:
    """``filter --sorting-order coordinate --haplotypecaller
    --reference-confidence GVCF`` on the ``n_reads`` reads of ``sam``."""
    from elprep_tpu_torch import cli
    from elprep_tpu_torch.io import sam as samio

    elfasta = ref["elfasta"]
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


# ---------------------------------------------------------------------------
# Phase 10: the graft entry points (graft_entry)
# ---------------------------------------------------------------------------

# bench.py's device step: 131 072 reads x 128 over a 2^20-base reference
GRAFT_READS = 1 << 17
DRYRUN_MESH_ENTRIES = 4
# runtime calls that enqueue work on the card
_HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                      "cudaGraphLaunch")


def _launch_counts(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: the runtime calls
    that enqueue work on the card (kernel launches, copies, sets, graph
    launches), by name, and the operations the card ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device += e.count
        elif e.key in _HOST_LAUNCH_CALLS:
            host[e.key] = host.get(e.key, 0) + e.count
    return {"host_calls": sum(host.values()), "by_call": host, "device_ops": device}


class _Timed:
    """Adds the wall seconds of every call of ``mod.attr`` in a block to
    ``into[attr]``."""

    def __init__(self, mod, attr, into: dict):
        self.mod, self.attr, self.orig, self.into = mod, attr, getattr(mod, attr), into

    def __enter__(self):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **k)
            finally:
                self.into[self.attr] = (self.into.get(self.attr, 0.0)
                                        + time.perf_counter() - t0)

        setattr(self.mod, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.orig)
        return False


def _same_tensors(what: str, got, want) -> None:
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, not {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what}: output {k} differs")


def _nbytes_t(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def graft_entry_phase(card: str, reps: int = 20) -> dict:
    """The port's graft entry points (elprep_tpu_torch.graft_entry) on the
    card. ``fused_device_step`` on bench.py's columns (GRAFT_READS reads x
    128 over a 2^20-base reference, put on the card first): its graph
    replay equal to the eager plain version on the card and to the eager
    run on the CPU, the packed step equal to it; the replay's and the
    plain version's CUDA-event times in turns, the launches of each under
    torch.profiler, the bytes bound and the host-to-device bytes of both
    argument lists. ``entry()`` on the card equal to ``entry`` on CPU
    copies. ``dryrun_multichip(DRYRUN_MESH_ENTRIES)`` on that many
    entries of cuda:0, every PairHMM launch on the warp path (the gloo
    multi-process part runs on the CPU)."""
    import torch

    from elprep_tpu_torch import graft_entry as ge

    cols = ge.fused_step_columns(GRAFT_READS)
    pcols = ge.pack_step_columns(cols)
    dargs = _to_cuda(*cols)
    pargs = _to_cuda(*pcols)
    step = ge.fused_device_step()
    eager = ge.fused_device_step_eager()
    t0 = time.perf_counter()
    got = step(*dargs)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    if len(step.graphs) != 1:
        raise AssertionError(f"fused_device_step holds {len(step.graphs)} graphs")
    plain = eager(*dargs)
    _same_tensors("fused_device_step graph vs eager on the card", got, plain)
    t0 = time.perf_counter()
    on_cpu = ge.fused_device_step_eager(device="cpu")(*cols)
    cpu_s = time.perf_counter() - t0
    _same_tensors("fused_device_step graph vs eager on the CPU", got, on_cpu)
    pstep = ge.fused_device_step_packed(width=cols[0].shape[1])
    _same_tensors("fused_device_step_packed vs dense", pstep(*pargs), got)
    if not torch.equal(torch.sort(got[0]).values, torch.arange(GRAFT_READS, device="cuda")):
        raise AssertionError("fused_device_step: the sort permutation is not one")

    times = _median_ms_turns({"graph": lambda: step(*dargs), "eager": lambda: eager(*dargs),
                              "packed": lambda: pstep(*pargs)}, reps)
    graph, _, _ = next(iter(step.graphs.values()))
    replay_ms = _median_ms(graph.replay, reps)
    launches = {"eager": _launch_counts(lambda: eager(*dargs)),
                "graph": _launch_counts(lambda: step(*dargs)),
                "replay": _launch_counts(graph.replay)}
    in_dense, in_packed = _nbytes(*cols), _nbytes(*pcols)
    out_bytes = _nbytes_t(got)
    res = {"rows": GRAFT_READS, "width": int(cols[0].shape[1]),
           "ms": times["graph"], "replay_ms": replay_ms, "eager_ms": times["eager"],
           "packed_ms": times["packed"], "reads_per_s": GRAFT_READS / times["graph"] * 1e3,
           "eager_over_graph": times["eager"] / times["graph"],
           "launches": launches, "h2d_bytes": in_dense, "h2d_bytes_packed": in_packed,
           "bound_ms": (in_dense + out_bytes) / PEAK_BYTES_PER_S * 1e3,
           "bound_ms_packed": (in_packed + out_bytes) / PEAK_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "first_call_s": capture_s, "cpu_eager_s": cpu_s}
    _log("fused_device_step: %d reads x %d; graph replay == eager on the card == eager "
         "on the CPU (%.2f s there), packed == dense; first call (warm-up + capture) "
         "%.2f s; per call %.4f ms (%.0f reads/s; the replay alone %.4f ms), eager "
         "%.4f ms (%.2fx), packed %.4f ms, median of %d in turns; launches: eager %s, "
         "a call %s, a replay %s; bound %.4f ms (%d + %d bytes), packed %.4f ms; "
         "H2D bytes dense %d, packed %d"
         % (GRAFT_READS, res["width"], cpu_s, capture_s, res["ms"], res["reads_per_s"],
            replay_ms, res["eager_ms"], res["eager_over_graph"], res["packed_ms"], reps,
            launches["eager"], launches["graph"], launches["replay"], res["bound_ms"],
            in_dense, out_bytes, res["bound_ms_packed"], in_dense, in_packed))

    fn, args = ge.entry()
    cfn, _ = ge.entry("cpu")
    eout = fn(*args)
    _same_tensors("entry() on the card vs the CPU", eout, cfn(*[a.cpu() for a in args]))
    entry = {"ms": _median_ms(lambda: fn(*args), reps), "sync_scalar": ge.sync_scalar(eout),
             "launches": _launch_counts(lambda: fn(*args))}
    _log("entry(): 256 reads x 128, card == CPU; %.4f ms per call, launches %s"
         % (entry["ms"], entry["launches"]))

    parts = {}
    _zero_pairhmm_counts()
    with _Timed(ge, "_dryrun_real_reads", parts), _Timed(ge, "dryrun_multihost", parts):
        t0 = time.perf_counter()
        ge.dryrun_multichip(DRYRUN_MESH_ENTRIES)
        dry_s = time.perf_counter() - t0
    launches_dry, by_path = _pairhmm_counts("dryrun_multichip")
    if launches_dry < DRYRUN_MESH_ENTRIES:
        raise AssertionError(f"dryrun_multichip: {launches_dry} PairHMM launches over "
                             f"{DRYRUN_MESH_ENTRIES} mesh entries")
    dry = {"mesh": DRYRUN_MESH_ENTRIES, "wall_s": dry_s, "launches": launches_dry,
           "launches_by_path": by_path, "parts_s": parts}
    _log("dryrun_multichip(%d) on %d x cuda:0: passed in %.2f s (filter --sharded "
         "against the whole-file run %.2f s, the two gloo processes on the CPU %.2f s); "
         "PairHMM launches %d, per path %s"
         % (DRYRUN_MESH_ENTRIES, DRYRUN_MESH_ENTRIES, dry_s, parts["_dryrun_real_reads"],
            parts["dryrun_multihost"], launches_dry, json.dumps(by_path)))
    return {"card": card, "fused_device_step": res, "entry": entry,
            "dryrun_multichip": dry}


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
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    build = phase("build", build_phase)
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
            fixtures = ex.submit(_make_fixtures, workdir)
            kernels = phase("kernel", kernel_phase)
            pool = phase("pool", start_pool)
            phase("golden", golden_phase, workdir)
            ref, fx, slice_sam, (lref, lfx), fixture_s = phase("fixture wait",
                                                                fixtures.result)
        _log("5-step fixture: %d reads over %d bp, %d known sites, the slice's %d "
             "reads, and the 2x300 fixture: %d reads of %d bp over %d bp, %d known "
             "sites, %d hypervariable stretches; in %.1f s in a process beside the "
             "phases above"
             % (fx["n_reads"], sum(n for _, n in SLICE_CONTIGS), len(ref["snps"]),
                SLICE_READS, lfx["n_reads"], LONG_READ_LEN,
                sum(n for _, n in LONG_CONTIGS), len(lref["snps"]),
                len(lref["stretches"]), fixture_s))
        ops = phase("device ops", device_ops_phase, fx, ref["elfasta"])
        five = phase("5-step", five_step_phase, workdir, fx, ref["elfasta"])
        sfm = phase("sfm", sfm_phase, workdir, fx, ref["elfasta"], five["pooled"]["out"])
        shd = phase("sharded", sharded_phase, workdir, fx, ref["elfasta"], five["pooled"])
        longr = phase("2x300", long_read_phase, workdir, lref, lfx)
        earlier = phase("slice", slice_phase, workdir, ref, slice_sam)
        graft = phase("graft entry", graft_entry_phase, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"device_ops": [
        {"name": name, "route": "torch", "source": source, "replaces": replaces,
         "launches": five["pooled"]["calls"][name],
         "slice_device_s": five["pooled"]["device_s"][name],
         "ms": ops[name]["ms"], "host_ms": ops[name]["host_ms"],
         "bound_ms": ops[name]["bound_ms"], "bound_by": "bytes", "rows": ops[name]["rows"]}
        for name, source, replaces in DEVICE_OPS] + [
        {"name": name, "route": "torch", "source": source, "replaces": replaces,
         "launches": shd["run"]["calls"][name],
         "slice_device_s": shd["run"]["device_s"][name],
         "ms": shd["library"][name]["ms"], "host_ms": None,
         "bound_ms": shd["library"][name]["bound_ms"], "bound_by": "bytes",
         "rows": shd["library"][name]["rows"], "mesh": SHARDED_MESH_ENTRIES}
        for name, source, replaces in SHARDED_OPS]}), flush=True)
    pooled, warm, serial = five["pooled"], five["warm"], five["serial"]
    kernel, stripe = kernels["warp"], kernels["stripe"]
    kernel["launches"] = pooled["launches"]
    kernel["launches_by_path"] = pooled["launches_by_path"]
    kernel["pairs_per_launch"] = pooled["pairs"] / pooled["launches"]
    kernel["launches_warm"] = warm["launches"]
    kernel["launches_serial"] = serial["launches"]
    kernel["pairs_per_launch_serial"] = serial["pairs"] / serial["launches"]
    kernel["launches_sfm"] = sfm["launches"]
    kernel["launches_sharded"] = shd["run"]["launches"]
    kernel["launches_sort_hc"] = earlier["launches"]
    lpooled, lserial = longr["pooled"], longr["serial"]
    stripe["launches"] = lpooled["launches_by_path"]["stripe"]
    stripe["launches_by_path_2x300"] = lpooled["launches_by_path"]
    stripe["pairs_per_launch_2x300"] = lpooled["pairs"] / lpooled["launches"]
    stripe["longest_read_2x300"] = max(lpooled["longest_reads"])
    stripe["launches_2x300_serial"] = lserial["launches_by_path"]["stripe"]
    stripe["ptxas"] = build["stripe_ptxas"]
    _log("5-step walls: pooled %.2f s from cold (%d workers of os.cpu_count() %d, "
         "spawn included; a pool alone starts and answers in %.2f s), %.2f s on the "
         "warm pool, serial %.2f s; sfm %.2f s; --sharded %.2f s on the warm pool, "
         "%.2f s through the multi-process runner; 2x300 %.2f s pooled, %.2f s serial"
         % (pooled["wall_s"], pooled["workers"], pool["cpu_count"], pool["start_s"],
            warm["wall_s"], serial["wall_s"], sfm["wall_s"], shd["run"]["wall_s"],
            shd["multihost"]["wall_s"], lpooled["wall_s"], lserial["wall_s"]))
    _log("smoke: %.1f s wall; phases: %s" % (
        time.perf_counter() - t_start, "; ".join("%s %.1f s" % kv for kv in walls.items())))
    kernel["launches_dryrun"] = graft["dryrun_multichip"]["launches"]
    print(json.dumps({"graft_entry": graft}), flush=True)
    print(json.dumps({"kernels": [kernel, stripe]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
