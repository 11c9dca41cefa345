#!/usr/bin/env python3
"""One run of one cell of the benchmark of elprep_tpu_torch, the port.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (``setup_s``, from the process's
start): the cell's inputs (genome FASTA, known-sites BED, SAM; the
reads' order and names from the seed) and converted with the port's own ``fasta-to-elfasta`` and
``bed-to-elsites``; the worker pool spawned where the traffic uses one,
beside the card's first use; one warm-up job on the same input.
Window (``--seconds``): the traffic's ``filter`` command as jobs, back to
back in this process, each one call of ``elprep_tpu_torch.cli.main``,
SAM in and BAM, metrics, recal report (and GVCF) out under ``TMPDIR``;
a job that ends after the window closed is not counted. Then the
outputs are held against the plain reference (reference/judge.py) and
deleted.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared and its limit,
which the last lines of standard error repeat. Exits non-zero, printing
no result, without a CUDA card, with fewer cards than the cell asks for,
outside a checkout that holds the port, or if JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
BANNED = ("jax", "jaxlib", "flax", "elprep_tpu")

# every build and kernel cache of the program and of torch at a fixed
# place inside the checkout (the PairHMM library builds into
# elprep_tpu_torch/_build/, the native library beside its sources)
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = os.path.join(CACHE, _sub)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def process_start() -> float:
    """This process's start on the wall clock, from /proc."""
    import time

    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(ln.split()[1]) for ln in fh if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def log(msg: str) -> None:
    print("gpubench: " + msg, file=sys.stderr, flush=True)


class RssSampler:
    """The largest sum of the resident memory of this process and the
    pool's workers, sampled every 50 ms (/proc/<pid>/statm); the chip
    machine's /proc has no VmHWM, the kernel's own high-water mark."""

    def __init__(self):
        import threading

        self.pids, self.peak = ["self"], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while not self._stop.wait(0.05):
            total = 0
            for pid in list(self.pids):
                try:
                    with open("/proc/%s/statm" % pid) as fh:
                        total += int(fh.read().split()[1]) * page
                except (OSError, ValueError, IndexError):
                    pass
            self.peak = max(self.peak, total)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return self.peak


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class StderrTee:
    """Copies what is written to sys.stderr, with the time of each line,
    to read the program's ``--timed`` phase lines (cli._timed)."""

    def __init__(self, real):
        import time

        self.real, self.lines, self._clock = real, [], time.perf_counter

    def write(self, s):
        now = self._clock()
        for ln in s.splitlines():
            if ln.strip():
                self.lines.append((now, ln))
        return self.real.write(s)

    def flush(self):
        self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


def timed_phases(lines):
    """[(phase, seconds)] from the program's ``--timed`` lines: a phase's
    message, then "  done in X.XXs" (the parser of chip_smoke.py)."""
    out, cur = [], None
    for _, ln in lines:
        s = ln.strip()
        if s.startswith("done in ") and s.endswith("s") and cur is not None:
            out.append((cur, float(s[len("done in "):-1])))
            cur = None
        elif s.endswith(".") and not s.startswith("gpubench"):
            cur = s
    return out


class PairLog:
    """Wraps the PairHMM's host packing (pairhmm_cuda.pack_pairs) to note
    each batch as sent: pairs, Σ read x haplotype cells, packed bytes."""

    def __init__(self, pc):
        self.pc, self.batches = pc, []

    def __enter__(self):
        import numpy as np

        orig = self.orig = self.pc.pack_pairs

        def pack_pairs(reads, haps, pair_r, pair_h, *a, **k):
            batch = orig(reads, haps, pair_r, pair_h, *a, **k)
            lr = np.fromiter((len(r[0]) for r in reads), np.int64, len(reads))
            lh = np.fromiter((len(h) for h in haps), np.int64, len(haps))
            pr, ph = np.asarray(pair_r, np.int64), np.asarray(pair_h, np.int64)
            self.batches.append({"pairs": int(len(pr)), "cells": int((lr[pr] * lh[ph]).sum()),
                                 "bytes": int(batch.blob.numel())})
            return batch

        self.pc.pack_pairs = pack_pairs
        return self

    def __exit__(self, *exc):
        self.pc.pack_pairs = self.orig


def job_paths(work: str, tag: str, paths: dict) -> dict:
    out = dict(paths)
    out.update(bam=os.path.join(work, tag + ".bam"), metrics=os.path.join(work, tag + ".metrics"),
               recal=os.path.join(work, tag + ".recal"), gvcf=os.path.join(work, tag + ".g.vcf.gz"))
    return out


def job_argv(traffic: dict, paths: dict, timed: bool) -> list:
    argv = [a.format(**paths) for a in traffic["command"]]
    return argv + (["--timed"] if timed else [])


def target_regions(argv):
    """The BED that a job's command line passes to ``--target-regions``,
    or None."""
    for k, a in enumerate(argv):
        if a.startswith("--target-regions="):
            return a.split("=", 1)[1]
        if a == "--target-regions" and k + 1 < len(argv):
            return argv[k + 1]
    return None


def run_job(cli, argv) -> int:
    """One job: ``elprep_tpu_torch.cli.main(argv)``; what it prints goes to
    standard error, so that the result stays the last line of output."""
    import contextlib
    import traceback

    try:
        with contextlib.redirect_stdout(sys.stderr):
            return int(cli.main(argv) or 0)
    except Exception:  # a failed job counts as failed, the run goes on
        traceback.print_exc(file=sys.stderr)
        return 1


def output_digest(paths: dict, kinds) -> str:
    """A digest of what a job's outputs say, leaving out their headers,
    which name the job's own paths and the time (the BAM's text header,
    the GVCF's and the metrics file's "#" lines)."""
    import gzip
    import hashlib
    import struct

    h = hashlib.sha256()
    for k in kinds:
        with open(paths[k], "rb") as fh:
            data = fh.read()
        if k == "bam":
            data = gzip.decompress(data)
            data = data[8 + struct.unpack_from("<i", data, 4)[0]:]
        elif k in ("gvcf", "metrics"):
            if k == "gvcf":
                data = gzip.decompress(data)
            data = b"\n".join(ln for ln in data.split(b"\n") if not ln.startswith(b"#"))
        h.update(k.encode() + b"\0" + data)
    return h.hexdigest()


def limits_for(cell) -> dict:
    """Each number compared and its limit: 0 unless the configuration's
    ``limits`` names another."""
    from reference import judge

    lim = {n: 0 for n in judge.numbers_for(cell.traffic["outputs"])}
    lim.update({k: v for k, v in cell.config.get("limits", {}).items() if k in lim})
    lim["jobs_failed"] = 0
    return lim


def main(argv=None, require_cuda: bool = True, device: str = "cuda", bench_root: str = None) -> int:
    """A run; the keyword arguments are for the CPU tests: no look for a
    card, the port on ``device``, and BENCHMARK.json with its gpubench/
    files under ``bench_root`` instead of this checkout."""
    import argparse
    import json
    import shutil
    import tempfile
    import time

    t_start = process_start()
    sampler = RssSampler()
    p = argparse.ArgumentParser(prog="gpubench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import cells

    try:
        cell = cells.load(bench_root or ROOT, args.workload,
                          os.path.join(bench_root, "gpubench") if bench_root else None)
    except (cells.CellError, OSError, ValueError, KeyError) as e:
        log("cannot load the cell: %s" % e)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "elprep_tpu_torch")):
        log("no elprep_tpu_torch in this checkout (%s): nothing to measure" % ROOT)
        return 2

    import numpy as np
    import torch

    if require_cuda:
        if not torch.cuda.is_available():
            log("torch.cuda.is_available() is false: no result")
            return 3
        if torch.cuda.device_count() < cell.chips:
            log("the cell asks for %d cards, torch sees %d: no result"
                % (cell.chips, torch.cuda.device_count()))
            return 3
    for var in [v for v in os.environ if v.startswith("ELPREP_TPU_")]:
        del os.environ[var]  # the program runs as the traffic's command says
    os.environ["ELPREP_TPU_TORCH_DEVICE"] = device

    from elprep_tpu_torch import cli
    from elprep_tpu_torch.ops import pairhmm_cuda as pc

    from gen import fixture
    from reference import judge

    cfg, traffic = cell.config, cell.traffic
    kinds = traffic["outputs"]
    workers = int(traffic.get("pool_workers", 0))
    setup = {}
    work = tempfile.mkdtemp(prefix="gpubench-", dir=os.environ.get("TMPDIR") or None)
    pool = None
    try:
        # 1. the cell's inputs (order and names from the seed), converted as a user would
        t = time.perf_counter()
        fx = fixture.make_fixture(cfg, args.seed)
        paths = fixture.write_inputs(fx, work, "input")
        paths["elfasta"] = os.path.join(work, "input.elfasta")
        paths["sites"] = os.path.join(work, "input.elsites")
        if (cli.main(["fasta-to-elfasta", paths["fasta"], paths["elfasta"]]) != 0
                or cli.main(["bed-to-elsites", paths["bed"], paths["sites"]]) != 0):
            log("converting the inputs failed")
            return 4
        setup["inputs_s"] = time.perf_counter() - t

        # 2-3. the pool's spawn, beside the card's first use
        t_pool = time.perf_counter()
        if workers > 1:
            from elprep_tpu_torch.hc.parallel import get_pool

            pool = get_pool(workers)
        if device == "cuda":
            t = time.perf_counter()
            torch.cuda.init()
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            setup["card_first_use_s"] = time.perf_counter() - t
            t = time.perf_counter()
            pc.library()  # nvcc on a checkout's first run, loaded after
            setup["pairhmm_library_s"] = time.perf_counter() - t
        if pool is not None:
            sampler.pids += [w["pid"] for w in pool.probe_workers()]
            setup["pool_start_s"] = time.perf_counter() - t_pool

        # 4. one warm-up job on the cell's own input: every program and
        # PairHMM path of the window, and the pool's workers warm (a job
        # on a quarter of the pairs left the first jobs of the window
        # slower than the rest)
        t = time.perf_counter()
        paths_before = dict(pc.LAUNCHES_BY_PATH)
        warm = job_paths(os.path.join(work, "warm"), "warm", paths)
        os.makedirs(os.path.join(work, "warm"))
        rc = run_job(cli, job_argv(traffic, warm, False))
        warm_paths = {k for k, v in pc.LAUNCHES_BY_PATH.items() if v > paths_before.get(k, 0)}
        shutil.rmtree(os.path.join(work, "warm"), ignore_errors=True)
        if rc != 0:
            log("the warm-up job failed (rc %d): no result" % rc)
            return 4
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup["warmup_s"] = time.perf_counter() - t
        setup_s = time.time() - t_start
        log("set-up %.3f s: %s; warm-up reached PairHMM paths %s"
            % (setup_s, ", ".join("%s %.3f" % kv for kv in setup.items()), sorted(warm_paths)))

        # the window
        trace_on = bool(args.trace)
        launches_before = dict(pc.LAUNCHES_BY_PATH)
        cpu_before = {w["pid"]: w.get("cpu_s", 0.0) for w in pool.probe_workers()} if pool else {}
        tee = StderrTee(sys.stderr) if trace_on else None
        prof = pairlog = None
        if trace_on:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts)
            pairlog = PairLog(pc).__enter__()
            sys.stderr = tee
            prof.__enter__()
            mark = record_function("gpubench.window")
            mark.__enter__()
        jobs, late = [], None
        t0 = time.perf_counter()
        deadline = t0 + args.seconds
        k = 0
        while time.perf_counter() < deadline:
            out = job_paths(work, "job%03d" % k, paths)
            n_lines = len(tee.lines) if tee else 0
            ts = time.perf_counter()
            rc = run_job(cli, job_argv(traffic, out, trace_on))
            if device == "cuda":
                torch.cuda.synchronize()
            te = time.perf_counter()
            job = {"rc": rc, "start": ts - t0, "end": te - t0, "paths": out,
                   "phases": timed_phases(tee.lines[n_lines:]) if tee else []}
            if te > deadline:
                # ended after the window: not counted, but traced (the
                # profiler and the pool's CPU seconds run to its end)
                late = job
                break
            log("job %d: rc %d, %.3f s" % (k, rc, te - ts))
            jobs.append(job)
            k += 1
        if trace_on:
            mark.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            sys.stderr = tee.real
            pairlog.__exit__()

        # after the window: readings, then the program's state freed
        probe = pool.probe_workers() if pool else []
        rss = sampler.stop()
        log("peak resident memory %d bytes (sampled)" % rss)
        mem_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
        launches = {p_: pc.LAUNCHES_BY_PATH[p_] - launches_before.get(p_, 0)
                    for p_ in pc.LAUNCHES_BY_PATH}
        log("window: %d jobs, PairHMM launches by path %s" % (len(jobs), launches))
        rec = {"jobs": jobs, "late": late, "n_reads": fx.n_reads,
               "read_length": int(cfg["read_length"]),
               "dup_share": float(cfg["dup_share"]), "setup": setup, "workers": workers,
               "worker_cpu_s": sum(w.get("cpu_s", 0.0) - cpu_before.get(w["pid"], 0.0)
                                   for w in probe),
               "launches": launches, "pair_batches": pairlog.batches if pairlog else []}
        if trace_on:
            import tracereduce

            tpath = os.path.join(work, "trace.json")
            prof.export_chrome_trace(tpath)
            marks = [(t_, ln.strip()) for t_, ln in tee.lines
                     if ln.strip().endswith(".") and not ln.strip().startswith(("done", "gpubench"))]
            with open(tpath) as fh:
                rec["trace"] = tracereduce.reduce(json.load(fh), marks, t0)
            os.remove(tpath)
            del prof
        if pool is not None:
            from elprep_tpu_torch.hc.parallel import shutdown_pool

            shutdown_pool()
            pool = None
        if device == "cuda":
            torch.cuda.empty_cache()

        # correctness: the reference once, then the jobs' outputs
        t = time.perf_counter()
        exp = judge.Expected(paths, kinds, [(c, p_) for c, p_, _, _ in fx.snps],
                             target_regions(job_argv(traffic, warm, False)))
        failed = [j for j in jobs if j["rc"] != 0]
        ok = [j for j in jobs if j["rc"] == 0]
        numbers = {n: 0 for n in limits_for(cell)}
        judged, digests = 0, {}
        rng = np.random.default_rng([args.seed & (2**63 - 1), 99])  # the jobs judged in full
        pick = set(rng.choice(len(ok), min(2, len(ok)), replace=False).tolist()) if ok else set()
        for i in sorted(pick) + [i for i in range(len(ok)) if i not in pick]:
            j = ok[i]
            try:
                d = output_digest(j["paths"], kinds)
            except OSError as e:
                log("job %d: outputs unreadable: %s" % (i, e))
                failed.append(j)
                continue
            if i not in pick and d in digests:
                continue  # byte for byte the outputs of a judged job
            notes = []
            got, why = judge.judge_files(exp, j["paths"], notes)
            for note in notes[:12]:
                log("job %d: %s" % (i, note))
            if got is None:
                log("job %d: %s" % (i, why))
                failed.append(j)
                continue
            judged += 1
            digests[d] = got
            for n_, v in got.items():
                numbers[n_] = max(numbers[n_], v)
        numbers["jobs_failed"] = len(failed)
        limits = limits_for(cell)
        correct = bool(ok) and judged > 0 and all(numbers[n_] <= limits[n_] for n_ in limits)
        log("reference and check %.3f s: %d jobs in the window, %d failed, %d judged in full, "
            "the others byte-equal to a judged one" % (time.perf_counter() - t, len(jobs),
                                                      len(failed), judged))

        # metrics
        metrics = {}
        done = [j for j in jobs if j["rc"] == 0 and j not in failed]
        if not trace_on:
            wall = max((j["end"] for j in done), default=0.0)
            values = {"reads_per_s": (fx.n_reads * len(done) / wall if wall > 0 else None, "reads/s"),
                      "peak_rss_gib": (rss / 2**30, "GiB"), "setup_s": (setup_s, "s")}
            for m in cell.end_to_end:
                v = values.get(m["name"], (None, None))[0]
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in cell.per_layer:
                v = cell.readers[m["name"]](rec)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if not done:
            correct = False
        if late is not None:
            log("one job ended after the window closed: not counted")

        found = banned_modules()
        if found:
            log("loaded in this process: %s; no result" % ", ".join(found))
            return 5
        result = {"correct": correct, "attempted": len(jobs), "failed": len(failed),
                  "metrics": metrics,
                  "device": {"platform": "gpu" if device == "cuda" else device,
                             "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                             "count": cell.chips, "memory_peak_bytes": mem_peak}}
        if trace_on and rec.get("trace"):
            tr = rec["trace"]
            result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            result["breakdown"] = {"device_ops": [[n_, s_] for n_, s_ in tr["device_ops"]],
                                   "idle_gaps": tr["idle_gaps"]}
        result["checks"] = {n_: {"value": numbers[n_], "limit": limits[n_]} for n_ in limits}
        for n_ in limits:
            log("check %s %s (limit %s)" % (n_, numbers[n_], limits[n_]))
        print(json.dumps(result), flush=True)
        return 0
    finally:
        sampler.stop()
        if pool is not None:
            from elprep_tpu_torch.hc.parallel import shutdown_pool

            shutdown_pool()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
