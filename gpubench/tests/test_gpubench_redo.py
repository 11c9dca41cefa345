"""The reader of ``hc.redo_pct`` (metrics/hc.redo_pct.py) on canned span
records: redone over genotyped regions per counted job, and nothing
where the records have no genotyping."""

import os

import pytest

import tiny
import cells
import spans


def reader():
    return cells.load_reader(os.path.join(tiny.BENCH, "metrics", "hc.redo_pct.py"))


def worker_spans(job, geno, redo, pid=200):
    out = [{"name": "job", "start": 0, "end": 10, "id": 1, "parent": None, "job": job,
            "pid": 100, "proc": "main", "thread": "MainThread", "attrs": None}]
    for k, name in enumerate(["worker.geno"] * geno + ["worker.redo"] * redo):
        out.append({"name": name, "start": k, "end": k + 1, "id": 10 + k, "parent": None,
                    "job": job, "pid": pid + k % 2, "proc": "worker",
                    "thread": "MainThread", "attrs": None})
    return out


def canned(monkeypatch, per_job, rcs):
    snap = {"spans": [], "counters": [], "dropped": 0}
    for j, (geno, redo) in enumerate(per_job):
        for s in worker_spans("j%d" % j, geno, redo):
            s["start"] += 100 * j
            s["end"] += 100 * j
            snap["spans"].append(s)
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    return {"jobs": [{"rc": rc} for rc in rcs]}


def test_redo_share_is_the_mean_over_counted_jobs(monkeypatch):
    # the failed second job (rc 1) is left out
    rec = canned(monkeypatch, [(200, 198), (10, 10), (100, 2)], [0, 1, 0])
    assert reader()(rec) == pytest.approx((99.0 + 2.0) / 2)


def test_a_job_without_genotyping_is_left_out(monkeypatch):
    rec = canned(monkeypatch, [(0, 0), (50, 0)], [0, 0])
    assert reader()(rec) == 0.0
    rec = canned(monkeypatch, [(0, 0)], [0])
    assert reader()(rec) is None


def test_nothing_without_records(monkeypatch):
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert reader()({"jobs": [{"rc": 0}]}) is None
