"""The per-layer readers and the trace reduction on canned records."""

import json
import os

import pytest

import tiny
import cells
import roofline
import run
import tracereduce

METRICS = os.path.join(tiny.BENCH, "metrics")


def reader(name):
    return cells.load_reader(os.path.join(METRICS, name + ".py"))


def record(**kw):
    rec = {"jobs": [], "n_reads": 1000, "read_length": 100, "dup_share": 0.0, "setup": {},
           "workers": 0, "worker_cpu_s": 0.0, "launches": {}, "pair_batches": []}
    rec.update(kw)
    return rec


def test_pairhmm_roofline_from_cells_and_kernel_time():
    batches = [{"pairs": 100, "cells": 10**9, "bytes": 10**6},
               {"pairs": 50, "cells": 5 * 10**8, "bytes": 10**6}]
    bound = sum(roofline.pairhmm_bound_s(b["cells"], b["bytes"], b["pairs"]) for b in batches)
    assert bound == pytest.approx(11 * 1.5e9 / 67e12)
    ops = [("pairhmm_warp_kernel", "kernel", 0.0, 200.0),
           ("pairhmm_stripe_kernel", "kernel", 500.0, 300.0),
           ("elementwise_kernel", "kernel", 900.0, 1000.0),
           ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2000.0, 5000.0)]
    got = reader("pairhmm.roofline_pct")(record(pair_batches=batches, trace={"ops": ops}))
    assert got == pytest.approx(100 * bound / 500e-6)
    assert reader("pairhmm.roofline_pct")(record(trace={"ops": ops})) is None
    # the device programs' share: kernels only, the copies left out
    nbytes = roofline.device_programs_bytes(1000, 100, 0.0)
    got = reader("device_ops.roofline_pct")(record(jobs=[{"rc": 0}], trace={"ops": ops}))
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 1000e-6)
    # the job that overran the window ran inside the traced span: its bytes count too
    got = reader("device_ops.roofline_pct")(record(jobs=[{"rc": 0}], late={"rc": 0},
                                                   trace={"ops": ops}))
    assert got == pytest.approx(2 * 100 * nbytes / 3.35e12 / 1000e-6)


def test_bytes_bound_when_cells_are_few():
    assert roofline.pairhmm_bound_s(1, 3.35e6, 0) == pytest.approx(1e-6)


def test_idle_share_from_a_synthetic_timeline():
    events = [{"ph": "X", "cat": "user_annotation", "name": "gpubench.window", "ts": 1000, "dur": 1000},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 1100, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 1150, "dur": 100},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1600, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "outside", "ts": 5000, "dur": 100}]
    tr = tracereduce.reduce({"traceEvents": events}, [(0.0003, "Calling variants.")], 0.0)
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx(250e-6)
    assert reader("device.idle_pct")(record(trace=tr)) == pytest.approx(75.0)
    # gaps, longest first: 1250-1600 before the phase mark at 1300, then
    # 1700-2000 after it, then 1000-1100
    assert tr["idle_gaps"] == [["set-up of the first job", pytest.approx(350e-6)],
                               ["Calling variants.", pytest.approx(300e-6)],
                               ["set-up of the first job", pytest.approx(100e-6)]]
    assert [n for n, _ in tr["device_ops"]] == ["a", "b", "Memcpy HtoD"]


def test_timed_parser():
    lines = [(0, "Reading SAM into memory and applying filters."), (1, "  done in 0.49s"),
             (1, "Marking optical duplicates (overlapped with recalibration)."),
             (1, "Base recalibration."), (2, "  done in 0.90s"), (2, "Apply BQSR."),
             (3, "  done in 0.13s"), (3, "Calling variants."), (9, "  done in 6.25s")]
    got = run.timed_phases(lines)
    assert got == [("Reading SAM into memory and applying filters.", 0.49),
                   ("Base recalibration.", 0.90), ("Apply BQSR.", 0.13),
                   ("Calling variants.", 6.25)]
    jobs = [{"rc": 0, "phases": got}, {"rc": 0, "phases": got}]
    assert reader("phase.bqsr_s")(record(jobs=jobs)) == pytest.approx(1.03)
    assert reader("phase.hc_s")(record(jobs=jobs)) == pytest.approx(6.25)
    assert reader("phase.write_s")(record(jobs=jobs)) is None
    busy = reader("hc.worker_busy_pct")(record(jobs=jobs, workers=4, worker_cpu_s=12.5))
    assert busy == pytest.approx(100 * 12.5 / (4 * 12.5))
    # the job that overran the window is in the pool's CPU seconds: its phase counts
    busy = reader("hc.worker_busy_pct")(record(jobs=jobs, late={"rc": 0, "phases": got},
                                               workers=4, worker_cpu_s=12.5))
    assert busy == pytest.approx(100 * 12.5 / (4 * 18.75))


def test_pairs_per_launch_and_setup_spans():
    rec = record(launches={"warp": 3, "stripe": 1, "cta": 0},
                 pair_batches=[{"pairs": 100, "cells": 1, "bytes": 1}] * 4,
                 setup={"card_first_use_s": 2.5})
    assert reader("pairhmm.pairs_per_launch")(rec) == 100
    assert reader("setup.card_first_use_s")(rec) == 2.5
    assert reader("setup.pool_start_s")(rec) is None


def test_every_per_layer_metric_has_a_reader():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        assert callable(reader(m["name"])), m["name"]
