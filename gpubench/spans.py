"""The program's own span records, for the per-layer readers.

A ``--timed`` job runs under the port's span recorder
(``elprep_tpu_torch/trace.py``), whose records stay in the process until
read: a traced run's window jobs each leave one root span ``job``, in
order, with the spans and counters of their phases, threads and pool
workers under its job id. :func:`load` matches those roots to
``rec["jobs"]`` in order and keeps the jobs completed in the window (the
job that overran it comes after them and is left out). A program without
the recorder, or a run without ``--timed``, gives None, and so does every
reader that uses it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

_CACHE: list = [None, None]  # the rec last loaded, and its Records


def snapshot() -> Optional[dict]:
    """The recorder's records in this process, or None where the program
    has no recorder."""
    try:
        from elprep_tpu_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


class Records:
    """The spans and counters of the counted jobs (``jobs``, their ids in
    window order), with every span of the run in ``all_spans``."""

    def __init__(self, snap: dict, jobs: List[dict]):
        self.all_spans = snap["spans"]
        roots = sorted((s for s in self.all_spans if s["name"] == "job" and s["proc"] == "main"),
                       key=lambda s: s["start"])
        self.roots = {r["job"]: r for r, j in zip(roots, jobs) if j["rc"] == 0}
        self.jobs = list(self.roots)
        self.by_job: Dict[object, List[dict]] = {j: [] for j in self.jobs}
        for s in self.all_spans:
            if s["job"] in self.by_job:
                self.by_job[s["job"]].append(s)
        self.counters = [c for c in snap["counters"] if c["job"] in self.by_job]

    def named(self, name: str, job) -> List[dict]:
        return [s for s in self.by_job[job] if s["name"] == name]

    def on_main_thread(self, name: str, job) -> List[dict]:
        """The spans ``name`` of ``job`` on the thread that ran the job."""
        root = self.roots[job]
        return [s for s in self.named(name, job)
                if s["pid"] == root["pid"] and s["thread"] == root["thread"]]

    def children(self, s: dict, name: str) -> List[dict]:
        return [c for c in self.by_job.get(s["job"], [])
                if c["name"] == name and c["pid"] == s["pid"] and c["parent"] == s["id"]]

    def mean(self, per_job: Callable) -> Optional[float]:
        """The mean over the counted jobs of ``per_job(job)``, leaving out
        the jobs where it is None; None where it is None for all."""
        vals = [v for v in (per_job(j) for j in self.jobs) if v is not None]
        return sum(vals) / len(vals) if vals else None

    def seconds_per_job(self, name: str) -> Optional[float]:
        """The mean over the counted jobs of the summed seconds of the
        spans ``name``; None where no counted job has one."""
        if not any(self.named(name, j) for j in self.jobs):
            return None
        return self.mean(lambda j: sum(s["end"] - s["start"] for s in self.named(name, j)) / 1e9)


def load(rec: dict) -> Optional[Records]:
    """The records of ``rec``'s counted jobs, or None where there are
    none (the last ``rec`` loaded is kept, so the readers of one run
    read one snapshot)."""
    if _CACHE[0] is rec:
        return _CACHE[1]
    snap = snapshot()
    out = None
    if snap and snap["spans"]:
        out = Records(snap, rec.get("jobs", []))
        if not out.jobs:
            out = None
    _CACHE[0], _CACHE[1] = rec, out
    return out
