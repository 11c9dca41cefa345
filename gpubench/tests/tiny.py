"""A tiny copy of the benchmark for the CPU tests: BENCHMARK.json (with
the tests' own cells) and the gpubench/ data files, with the tests' own
configuration and traffic (tests/configs/, tests/traffic/), under a
temporary root, the configurations cut to a few kb and the pool to two
workers, and a run of run.py on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

TINY = {"platinum_wgs50x_2x101": ([["chr1", 9000], ["chr2", 6000]], 50)}
# cells of the tests only, added as entries the way a later cell is: the
# prep mix runs without the pool, so most fault tests take it
EXTRA_CELLS = [{"name": "wgs50x.prep", "config": "platinum_wgs50x_2x101", "traffic": "prep",
                "chips": 1, "why": "a test cell: the five-step reads without --haplotypecaller"},
               {"name": "capture.5step", "config": "capture_test", "traffic": "five_step_targets",
                "chips": 1, "why": "a test cell: a capture design, the 5-step command with "
                                   "--target-regions"}]


def make_root(dest: str) -> str:
    """A benchmark root under ``dest`` whose cells run in seconds."""
    os.makedirs(os.path.join(dest, "gpubench"), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"] += EXTRA_CELLS
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(dest, "gpubench", sub),
                        dirs_exist_ok=True)
    for sub in ("configs", "traffic"):  # the tests' own, added as a later cell's would be
        shutil.copytree(os.path.join(HERE, sub), os.path.join(dest, "gpubench", sub),
                        dirs_exist_ok=True)
    for name, (contigs, depth) in TINY.items():
        path = os.path.join(dest, "gpubench", "configs", name + ".json")
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(contigs=contigs, depth=depth)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for name in os.listdir(os.path.join(dest, "gpubench", "traffic")):
        path = os.path.join(dest, "gpubench", "traffic", name)
        with open(path) as fh:
            t = json.load(fh)
        t["command"] = ["2" if a == "8" else a for a in t["command"]]
        t["pool_workers"] = min(t["pool_workers"], 2)
        with open(path, "w") as fh:
            json.dump(t, fh)
    return dest


def run_cpu(root: str, workload: str, seed: int, seconds: float = 3, trace: int = 0):
    """(exit code, the last line's JSON or None) of a run on the CPU."""
    import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], require_cuda=False, device="cpu", bench_root=root)
    lines = out.getvalue().strip().split("\n")
    try:
        return rc, json.loads(lines[-1])
    except (ValueError, IndexError):
        return rc, None
