#!/usr/bin/env python3
"""What ``--timed`` (the port's span recorder) costs a job: the cell's
command run in turns without and with ``--timed`` on the cell's own
inputs, in one process on a warm pool.

    python3 gpubench/timed_cost.py --workload wgs50x.5step --seed N --pairs 6

From the root of a checkout, on a machine with the card. Set-up as
run.py's (inputs from the seed, converters, the pool, one warm-up job),
then ``--pairs`` pairs of jobs, the order inside a pair alternating
(plain, timed, timed, plain, ...); the recorder's records are dropped
after each timed job. The last line of standard output is one JSON
object: each side's job walls in run order, their medians and the
relative cost of the medians, and the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import run  # sets the caches and sys.path as a benchmark run does


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench/timed_cost.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=6)
    args = p.parse_args(argv)

    import torch

    import cells
    from gen import fixture

    if not torch.cuda.is_available():
        run.log("torch.cuda.is_available() is false: no result")
        return 3
    cell = cells.load(run.ROOT, args.workload)
    for var in [v for v in os.environ if v.startswith("ELPREP_TPU_")]:
        del os.environ[var]  # the program runs as the traffic's command says
    os.environ["ELPREP_TPU_TORCH_DEVICE"] = "cuda"
    from elprep_tpu_torch import cli, trace
    from elprep_tpu_torch.hc.parallel import get_pool, shutdown_pool

    work = tempfile.mkdtemp(prefix="gpubench-cost-", dir=os.environ.get("TMPDIR") or None)
    try:
        fx = fixture.make_fixture(cell.config, args.seed)
        paths = fixture.write_inputs(fx, work, "input")
        paths["elfasta"] = os.path.join(work, "input.elfasta")
        paths["sites"] = os.path.join(work, "input.elsites")
        if (cli.main(["fasta-to-elfasta", paths["fasta"], paths["elfasta"]]) != 0
                or cli.main(["bed-to-elsites", paths["bed"], paths["sites"]]) != 0):
            run.log("converting the inputs failed")
            return 4
        workers = int(cell.traffic.get("pool_workers", 0))
        if workers > 1:
            get_pool(workers)
        walls = {False: [], True: []}
        for k in range(-1, 2 * args.pairs):
            # k = -1 is the warm-up; then plain, timed, timed, plain, ...
            timed = k >= 0 and (k % 4) in (1, 2)
            out = run.job_paths(work, "job%03d" % (k + 1), paths)
            t = time.perf_counter()
            rc = run.run_job(cli, run.job_argv(cell.traffic, out, timed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if rc != 0:
                run.log("job %d failed (rc %d)" % (k, rc))
                return 4
            if k >= 0:
                walls[timed].append(wall)
                run.log("job %d %s: %.3f s" % (k, "timed" if timed else "plain", wall))
            trace.clear()
            for f in ("bam", "metrics", "recal", "gvcf"):
                if os.path.exists(out[f]):
                    os.remove(out[f])
        med = {side: statistics.median(w) for side, w in walls.items()}
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "plain_s": walls[False], "timed_s": walls[True],
                          "plain_median_s": med[False], "timed_median_s": med[True],
                          "cost_pct": 100.0 * (med[True] / med[False] - 1.0),
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        return 0
    finally:
        shutdown_pool()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
