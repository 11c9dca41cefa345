#!/usr/bin/env python3
"""The controls of the BQSR numbers of the comparison that decides
``correct``: the plain reference put in the program's place, made wrong
in one way, and judged by the numbers a run compares.

    python3 gpubench/control.py --workload CELL --seeds N [N ...]

Two controls, each over the cell's own inputs at its own size:
- ``float32``: every empirical quality of BQSR (tables, report and the
  recalibrated qualities) computed in float32, the precision below the
  float64 that elPrep computes in;
- ``dups_in_tables``: the BQSR tables counted before duplicate marking,
  duplicates included (the overlap a faster pipeline would be tempted
  by), which breaks the stated guarantee that BQSR sees what elPrep's
  does.
The GVCF's genotypes are held against faults planted in the program
itself (faults.py: ``hets_uncalled``, ``genotype_flipped``), since the
reference has no HaplotypeCaller to put in its place.
Prints one JSON line per seed and control with the numbers it reads.
Needs no card and does not import the program."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from gen import fixture  # noqa: E402
from reference import bqsr, judge, records  # noqa: E402

CONTROLS = ("float32", "dups_in_tables")


def numbers(exp: judge.Expected, rc: bqsr.Recalibration) -> dict:
    """recal_row_mismatches and qual_mismatches of ``rc`` in the program's
    place, against the reference ``exp``."""
    quals = rc.apply(exp.reads)
    return {"recal_row_mismatches": judge.recal_row_mismatches(exp.recal, rc.report_rows()),
            "qual_mismatches": sum(a != b for a, b in zip(quals, exp.quals))}


def run_controls(cfg: dict, seed: int, workdir: str, with_targets: bool = False) -> dict:
    """The controls' numbers on ``cfg``'s inputs for ``seed``; with
    ``with_targets``, over the reads that its target BED keeps, as a
    cell whose traffic passes ``--target-regions``."""
    fx = fixture.make_fixture(cfg, seed)
    paths = fixture.write_inputs(fx, workdir, "input")
    exp = judge.Expected(paths, ["bam", "metrics", "recal"], [],
                         paths["targets"] if with_targets else None)
    known = records.read_known_sites(paths["bed"])
    out = {}
    for name in CONTROLS:
        if name == "float32":
            rc = bqsr.Recalibration(exp.header, exp.reads, exp.dup, exp.genome, known,
                                    dtype=np.float32)
        else:
            rc = bqsr.Recalibration(exp.header, exp.reads, [False] * len(exp.reads),
                                    exp.genome, known)
        out[name] = numbers(exp, rc)
    return out


def main(argv=None) -> int:
    import cells

    p = argparse.ArgumentParser(prog="gpubench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = cells.load(os.path.dirname(HERE), args.workload)
    work = tempfile.mkdtemp(prefix="gpubench-control-", dir=os.environ.get("TMPDIR") or None)
    try:
        for seed in args.seeds:
            with_targets = "--target-regions" in cell.traffic["command"]
            for name, got in run_controls(cell.config, seed, work, with_targets).items():
                print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                                  "numbers": got}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
