"""The readers of the program's span records (spans.py) on canned records
and spans, and the clock fit (spanclock.py) on planted offsets, rates
and a hand-built timeline."""

import os

import pytest

import tiny
import cells
import spanclock
import spans

METRICS = os.path.join(tiny.BENCH, "metrics")
NEW = ["hc.main_busy_s", "hc.recv_s", "hc.combine_s", "pairhmm.pack_s",
       "pairhmm.batch_wait_ms", "pairhmm.pending_idle_pct", "hc.task_queue_wait_ms",
       "hc.worker_sw_s", "write.thread_s"]
S = 10**9


def reader(name):
    return cells.load_reader(os.path.join(METRICS, name + ".py"))


def span(name, start, end, job, sid, parent=None, pid=100, proc="main", thread="MainThread",
         attrs=None):
    return {"name": name, "start": start, "end": end, "id": sid, "parent": parent, "job": job,
            "pid": pid, "proc": proc, "thread": thread, "attrs": attrs}


def one_job(job, t0, base_id):
    """A job at t0 (ns): phase.hc of 7 s with 1.5 s of waits on the main
    thread and 1 s of waits on another thread, reads, combines, a batch
    with pack and device, a worker task and the SW counter."""
    i = base_id
    out = [span("job", t0, t0 + 10 * S, job, i),
           span("phase.hc", t0 + 2 * S, t0 + 9 * S, job, i + 1, parent=i),
           span("hc.wait", t0 + 3 * S, t0 + 4 * S, job, i + 2, parent=i + 1),
           span("hc.wait", t0 + 5 * S, t0 + 55 * S // 10, job, i + 3, parent=i + 1),
           span("hc.wait", t0 + 5 * S, t0 + 6 * S, job, i + 4, thread="other"),
           span("hc.recv", t0 + 4 * S, t0 + 41 * S // 10, job, i + 5, parent=i + 1),
           span("hc.recv", t0 + 6 * S, t0 + 61 * S // 10, job, i + 6, thread="other"),
           span("hc.combine", t0 + 3 * S, t0 + 32 * S // 10, job, i + 7, thread="hc-combiner"),
           span("hc.combine", t0 + 4 * S, t0 + 42 * S // 10, job, i + 8, thread="hc-combiner"),
           span("pairhmm.batch", t0 + 5 * S, t0 + 6 * S, job, i + 9, thread="d",
                attrs={"regions": 4, "pairs": 10, "cells": 1000, "bytes": 10,
                       "wait_sum_ns": 8 * 10**6, "wait_max_ns": 3 * 10**6}),
           span("pairhmm.pack", t0 + 5 * S, t0 + 53 * S // 10, job, i + 10, parent=i + 9,
                thread="d"),
           span("pairhmm.device", t0 + 53 * S // 10, t0 + 6 * S, job, i + 11, parent=i + 9,
                thread="d", attrs={"bytes": 10, "launches": 1}),
           span("worker.task", t0 + 3 * S, t0 + 4 * S, job, 1, pid=200, proc="worker",
                attrs={"regions": 3, "sent": t0 + 3 * S - 4 * 10**6}),
           span("write.bam", t0 + 2 * S, t0 + 25 * S // 10, job, i + 12, thread="output-writer")]
    counters = [{"job": job, "pid": 200, "proc": "worker", "thread": "MainThread",
                 "name": "hc.sw", "count": 7, "ns": 3 * S // 2},
                {"job": job, "pid": 201, "proc": "worker", "thread": "MainThread",
                 "name": "hc.sw", "count": 1, "ns": S // 2}]
    return out, counters


@pytest.fixture
def canned(monkeypatch):
    """Two counted jobs, a failed one between them and the late one after
    them, all with the same records."""
    snap = {"spans": [], "counters": [], "dropped": 0}
    for k, job in enumerate(("a", "failed", "b", "late")):
        s, c = one_job(job, 100 * S * (k + 1), 100 * k)
        snap["spans"] += s
        snap["counters"] += c
    # the second counted job waits 1 s more on the main thread
    snap["spans"].append(span("hc.wait", 306 * S, 307 * S, "b", 999, parent=201))
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    return {"jobs": [{"rc": 0}, {"rc": 1}, {"rc": 0}], "late": {"rc": 0}}


def test_readers_on_canned_spans(canned):
    rec = canned
    assert reader("hc.main_busy_s")(rec) == pytest.approx(((7 - 1.5) + (7 - 2.5)) / 2)
    assert reader("hc.recv_s")(rec) == pytest.approx(0.1)
    assert reader("hc.combine_s")(rec) == pytest.approx(0.4)
    assert reader("pairhmm.pack_s")(rec) == pytest.approx(0.3)
    assert reader("pairhmm.batch_wait_ms")(rec) == pytest.approx(2.0)
    assert reader("hc.task_queue_wait_ms")(rec) == pytest.approx(4.0)
    assert reader("hc.worker_sw_s")(rec) == pytest.approx(2.0)
    assert reader("write.thread_s")(rec) == pytest.approx(0.5)
    # no trace, no clock: no idle share
    assert reader("pairhmm.pending_idle_pct")(rec) is None


def test_readers_read_nothing_without_records(monkeypatch):
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    rec = {"jobs": [{"rc": 0}], "late": None}
    assert all(reader(n)(rec) is None for n in NEW)
    # records, but no job root (a program that records nothing per job)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    monkeypatch.setattr(spans, "snapshot", lambda: {
        "spans": [span("hc.wait", 0, 1, None, 1)], "counters": [], "dropped": 0})
    assert all(reader(n)({"jobs": [{"rc": 0}]}) is None for n in NEW)


def test_readers_read_nothing_from_a_program_without_the_recorder(monkeypatch):
    """A parent commit's program has no elprep_tpu_torch.trace: the
    readers return None and do not raise."""
    import builtins

    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "elprep_tpu_torch" and fromlist and "trace" in fromlist:
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    assert spans.snapshot() is None
    assert all(reader(n)({"jobs": [{"rc": 0}], "trace": {"ops": []}}) is None for n in NEW)


def _planted(n, offset_us, rate=1.0, lead_us=30.0, tail_us=20.0, x0=5e12):
    """n device spans (ns) and their kernels (trace us): each kernel
    starts lead_us after its span and ends tail_us before its end."""
    spans_, kernels = [], []
    for i in range(n):
        s = x0 + i * 7.5e8  # a span every 0.75 s
        e = s + 5e5 + (i % 3) * 1e5
        ks = (s / 1e3 + lead_us) - x0 / 1e3
        ke = (e / 1e3 - tail_us) - x0 / 1e3
        kernels.append((offset_us + rate * ks, rate * (ke - ks)))
        spans_.append((s, e, 1))
    return spans_, kernels


def test_fit_recovers_a_planted_offset():
    sp, ks = _planted(30, 1.7e15)
    f = spanclock.fit(sp, ks)
    assert f is not None and f.rate == 1.0
    # microseconds near 1.7e15 hold a quarter of a microsecond
    assert abs(f.offset_us - 1.7e15) <= f.width_us / 2 + 1.0
    assert f.width_us == pytest.approx(50.0, abs=1.0)
    # there and back within a quarter of a microsecond
    assert f.to_program(f.to_trace(5e12 + 123456.0)) == pytest.approx(5e12 + 123456.0, abs=250)


def test_fit_recovers_a_planted_rate():
    # 40 ppm over 30 spans of 0.75 s: 0.9 ms of drift, far wider than
    # the 50 us bracket, so the rate is fitted
    sp, ks = _planted(30, 3.2e9, rate=1 + 40e-6)
    f = spanclock.fit(sp, ks)
    assert f is not None
    assert f.rate == pytest.approx(1 + 40e-6, abs=2e-6)
    assert 0 <= f.width_us <= 50.01
    for (s, e, _), (ts, d) in zip(sp, ks):
        assert f.to_program(ts) >= s - f.width_us * 1e3 and f.to_program(ts + d) <= e + f.width_us * 1e3


def test_fit_none_on_count_mismatch_or_empty_bracket():
    sp, ks = _planted(10, 100.0)
    assert spanclock.fit(sp, ks[:-1]) is None
    assert spanclock.fit(sp[:-1] + [(sp[-1][0], sp[-1][1], 2)], ks) is None
    assert spanclock.fit([], []) is None
    # a kernel longer than its span fits no offset
    bad = list(ks)
    bad[4] = (bad[4][0], 10 ** 6)
    assert spanclock.fit(sp, bad) is None


def test_pending_idle_on_a_hand_built_timeline(monkeypatch):
    """phase.hc over [0, 1 ms] of program time; the card busy with a copy
    over [0.1, 0.2] ms and the PairHMM kernel over [0.46, 0.54] ms, inside
    its device span [0.45, 0.55] ms; the batch's inputs pending from
    0.15 ms (its device start less wait_max) to 0.45 ms. Idle: 0.82 ms,
    of which [0.2, 0.45] ms pending."""
    p0, off = 10**12, 4.2e9  # the trace's clock: program us + off
    snap = {"spans": [span("job", p0 - 10**6, p0 + 2 * 10**6, "j", 1),
                      span("phase.hc", p0, p0 + 10**6, "j", 2, parent=1),
                      span("pairhmm.batch", p0 + 400_000, p0 + 600_000, "j", 3, thread="d",
                           attrs={"regions": 2, "wait_sum_ns": 400_000, "wait_max_ns": 300_000}),
                      span("pairhmm.device", p0 + 450_000, p0 + 550_000, "j", 4, parent=3,
                           thread="d", attrs={"launches": 1})],
            "counters": [], "dropped": 0}
    ops = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", p0 / 1e3 + 100 + off, 100.0),
           ("void pairhmm_warp_kernel<4>(...)", "kernel", p0 / 1e3 + 460 + off, 80.0)]
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    rec = {"jobs": [{"rc": 0}], "trace": {"ops": ops}}
    assert reader("pairhmm.pending_idle_pct")(rec) == pytest.approx(100 * 250 / 820, rel=1e-9)
    assert reader("pairhmm.batch_wait_ms")(rec) == pytest.approx(0.2)
    # a kernel the spans do not hold: no fit, no reading
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    rec["trace"]["ops"] = ops + [("pairhmm_warp_kernel", "kernel", p0 / 1e3 + off + 900, 5.0)]
    assert reader("pairhmm.pending_idle_pct")(rec) is None


def test_interval_helpers():
    assert spanclock.union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert spanclock.complement([(1, 2), (3, 5)], 0, 4) == [(0, 1), (2, 3)]
    assert spanclock.intersect([(0, 2), (3, 4)], [(1, 3.5)]) == [(1, 2), (3, 3.5)]
    assert spanclock.total([(0, 2), (3, 4)]) == 3


class _Recs:
    def __init__(self, all_spans):
        self.all_spans = all_spans


def _jobs_planted(n_jobs, per_job, offset_us, shift_us):
    """``per_job`` device spans a job (jobs 30 s apart) and their kernels
    on the trace's clock, each job's kernels moved by ``shift_us[job]``
    (a list: per kernel)."""
    spans_, kernels = [], []
    for j in range(n_jobs):
        sp, ks = _planted(per_job, offset_us, x0=5e12 + j * 3e10)
        # _planted counts trace time from its own x0: put it on one clock
        ks = [(ts + j * 3e7 + shift_us[j][k], d) for k, (ts, d) in enumerate(ks)]
        spans_ += [span("pairhmm.device", s, e, "job%d" % j, 1000 * j + k, thread="d",
                        attrs={"launches": n}) for k, (s, e, n) in enumerate(sp)]
        kernels += ks
    return spans_, [("pairhmm_warp_kernel", "kernel", ts, d) for ts, d in kernels]


def test_job_fits_hold_where_the_window_fit_does_not():
    """The profiler's clock moves 700 us earlier for the middle job's
    kernels: one bracket over the window is empty, each job's holds and
    finds its own offset."""
    shift = [[0.0] * 5, [-700.0] * 5, [0.0] * 5]
    sp, ops = _jobs_planted(3, 5, 2.5e9, shift)
    every = [(s["start"], s["end"], 1) for s in sp]
    assert spanclock.fit(every, [(ts, d) for _, _, ts, d in ops]) is None
    fits = spanclock.job_fits(_Recs(sp), ops)
    assert sorted(fits) == ["job0", "job1", "job2"]
    for k in range(3):
        f = fits["job%d" % k]
        # the job's first span starts at 5e12 + k * 3e10 ns, on the trace
        # at the offset, 3e7 us a job later, and moved where it moved
        want = 2.5e9 + k * 3e7 + shift[k][0]
        assert abs(f.to_trace(5e12 + k * 3e10) - want) <= f.width_us / 2 + 1.0


def test_job_fits_leave_out_a_job_whose_own_bracket_is_empty():
    """Two kernels inside the middle job move: that job alone goes."""
    shift = [[0.0] * 5, [0.0, 0.0, -800.0, -800.0, 0.0], [0.0] * 5]
    sp, ops = _jobs_planted(3, 5, 2.5e9, shift)
    assert sorted(spanclock.job_fits(_Recs(sp), ops)) == ["job0", "job2"]
    # a kernel missing from the trace: the split is unknown, no fit at all
    assert spanclock.job_fits(_Recs(sp), ops[:-1]) == {}


def _timeline_job(job, t0, sid, wait_max_ns, device_us):
    """One job of the hand-built timeline at ``t0`` (ns): phase.hc over
    [t0, t0 + 1 ms]; a batch per (start, end) in ``device_us`` (us after
    t0) with the wait ``wait_max_ns`` before its device span."""
    out = [span("job", t0 - 10**6, t0 + 2 * 10**6, job, sid),
           span("phase.hc", t0, t0 + 10**6, job, sid + 1, parent=sid)]
    for k, (a, b) in enumerate(device_us):
        bid = sid + 2 + 2 * k
        out += [span("pairhmm.batch", t0 + a * 1000 - 50_000, t0 + b * 1000 + 50_000, job, bid,
                     thread="d", attrs={"regions": 2, "wait_sum_ns": wait_max_ns,
                                        "wait_max_ns": wait_max_ns}),
                span("pairhmm.device", t0 + a * 1000, t0 + b * 1000, job, bid + 1, parent=bid,
                     thread="d", attrs={"launches": 1})]
    return out


def test_pending_idle_with_a_job_fit_each(monkeypatch):
    """Three jobs 10 ms apart, each with a copy over [100, 200] us of its
    phase.hc and a kernel 10 us inside each device span. Job a: pending
    over [150, 450] us, so 250 of its 820 us idle; job b, its kernel and
    copy 700 us earlier on the trace's clock: pending over [350, 450], 100
    of 820; job c: a second kernel moved 700 us inside the job, so no fit
    and counted in neither part."""
    p0, off = 10**12, 4.2e9
    snap = {"spans": (_timeline_job("a", p0, 1, 300_000, [(450, 550)])
                      + _timeline_job("b", p0 + 10**7, 11, 100_000, [(450, 550)])
                      + _timeline_job("c", p0 + 2 * 10**7, 21, 300_000, [(450, 550), (700, 750)])),
            "counters": [], "dropped": 0}

    def ops_of(t0_ns, shift_us, kernels_us):
        base = t0_ns / 1e3 + off + shift_us
        return ([("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", base + 100, 100.0)]
                + [("void pairhmm_warp_kernel<4>(...)", "kernel", base + a, b - a)
                   for a, b in kernels_us])

    ops = (ops_of(p0, 0.0, [(460, 540)]) + ops_of(p0 + 10**7, -700.0, [(460, 540)])
           + ops_of(p0 + 2 * 10**7, 0.0, [(460, 540), (10, 40)]))
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    rec = {"jobs": [{"rc": 0}] * 3, "trace": {"ops": ops}}
    assert reader("pairhmm.pending_idle_pct")(rec) == pytest.approx(100 * 350 / 1640, rel=1e-9)
    # the old single fit over the window reads nothing here
    r = spans.load(rec)
    every = [(s["start"], s["end"], 1) for s in r.all_spans if s["name"] == "pairhmm.device"]
    assert spanclock.fit(every, [(ts, d) for _, c, ts, d in ops if c == "kernel"]) is None
    # no job with a fit: no reading
    monkeypatch.setattr(spans, "_CACHE", [None, None])
    rec["trace"]["ops"] = ops[:-1]
    assert reader("pairhmm.pending_idle_pct")(rec) is None
