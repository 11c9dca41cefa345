"""Reduction of a torch.profiler trace (its chrome-trace JSON) over the
measured window: when the device was busy, which operations took the
time, and the longest gaps with what the host was doing then."""

from __future__ import annotations

from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "gpubench.window"


def window_and_ops(trace: dict):
    """((start, end) of the window mark in the trace's microseconds,
    [(name, category, start, duration)] of every device operation)."""
    window = None
    ops = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((ev.get("name", ""), cat, float(ev["ts"]), float(ev.get("dur", 0.0))))
        elif ev.get("name") == WINDOW_MARK and cat in ("user_annotation", "cpu_op", "python_function"):
            window = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
    return window, ops


def busy_and_gaps(ops, lo: float, hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds in [lo, hi] (microseconds) covered by the union of the
    operations' intervals, and the gaps between them in that span."""
    spans = sorted((max(ts, lo), min(ts + d, hi)) for _, _, ts, d in ops
                   if ts + d > lo and ts < hi)
    busy, gaps, cur = 0.0, [], lo
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy / 1e6, gaps


def reduce(trace: dict, marks: List[Tuple[float, str]], t0: float) -> Dict:
    """The window's device numbers. ``marks`` are (perf_counter seconds,
    label) of what the host began at that time (the program's phase lines);
    ``t0`` the perf_counter time at which the window mark opened."""
    window, ops = window_and_ops(trace)
    if window is None:
        return {}
    lo, hi = window
    busy, gaps = busy_and_gaps(ops, lo, hi)
    by_name: Dict[str, float] = {}
    for name, _, ts, d in ops:
        if lo <= ts < hi:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
    at = sorted((lo + (t - t0) * 1e6, label) for t, label in marks)

    def label(ts: float) -> str:
        out = "set-up of the first job"
        for when, what in at:
            if when > ts:
                break
            out = what
        return out

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy,
        "ops": [(n, c, ts, d) for n, c, ts, d in ops if lo <= ts < hi],
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[label(a), (b - a) / 1e6] for a, b in longest],
    }
