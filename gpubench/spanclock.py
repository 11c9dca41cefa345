"""The program's clock mapped onto a torch.profiler trace's device
timeline, by brackets, once per job.

The span recorder (elprep_tpu_torch/trace.py) stamps spans with
``time.perf_counter_ns()``; the profiler's chrome trace stamps device
operations in microseconds on its own time base, which tracereduce keeps
without its origin. Each PairHMM kernel runs inside its
``pairhmm.device`` span (from the copy to the card through the result's
read-back), so the i-th kernel of the trace and the i-th launch of those
spans are one event. With ``trace = offset + rate * (program - x0)``
every pair bounds the offset:

    kernel end - rate * span end  <=  offset  <=  kernel start - rate * span start

and the offset lies in the intersection of all these intervals. The
intersection's width is the alignment error; an empty one, or unequal
counts, gives no fit. The rate is 1 unless the brackets of the first and
the last third of the pairs disagree by more than the width: then the
rate that leaves the widest intersection is fitted too (the two clocks
may run at slightly different rates over a long window).

The fit is made per job (:func:`job_fits`): the profiler's clock has
been seen to move against the program's for a few consecutive kernels
mid-window, which empties a single bracket over the whole window; a
job's own bracket holds wherever the move falls between jobs, and a job
whose bracket is empty is left out alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Fit:
    offset_us: float  # the trace's time at x0, the first span's start
    rate: float       # trace microseconds per program microsecond
    x0_us: float      # the first span's start, program microseconds
    width_us: float   # the bracket's width: the alignment error

    def to_trace(self, ns: float) -> float:
        """Program nanoseconds to trace microseconds."""
        return self.offset_us + self.rate * (ns / 1e3 - self.x0_us)

    def to_program(self, us: float) -> float:
        """Trace microseconds to program nanoseconds."""
        return (self.x0_us + (us - self.offset_us) / self.rate) * 1e3


def _bracket(pairs, rate: float) -> Tuple[float, float]:
    lo = max(ke - rate * se for (ss, se), (ks, ke) in pairs)
    hi = min(ks - rate * ss for (ss, se), (ks, ke) in pairs)
    return lo, hi


def _widest_rate(pairs, guess: float) -> float:
    """The rate near ``guess`` with the widest bracket (its width is
    concave in the rate, so a ternary search finds it)."""
    span = 2 * abs(guess - 1.0) + 1e-9
    a, b = guess - span, guess + span

    def width(r):
        lo, hi = _bracket(pairs, r)
        return hi - lo

    for _ in range(200):
        m1, m2 = a + (b - a) / 3, b - (b - a) / 3
        if width(m1) < width(m2):
            a = m1
        else:
            b = m2
    return (a + b) / 2


def fit(spans: Sequence[Tuple[int, int, int]],
        kernels: Sequence[Tuple[float, float]]) -> Optional[Fit]:
    """``spans``: (start ns, end ns, kernels launched inside) of each
    ``pairhmm.device`` span; ``kernels``: (start us, duration us) of each
    PairHMM kernel in the trace. None on unequal counts or an empty
    bracket."""
    ivals = sorted((s, e) for s, e, k in spans for _ in range(int(k)))
    ks = sorted((float(ts), float(ts) + float(d)) for ts, d in kernels)
    if not ivals or len(ivals) != len(ks):
        return None
    x0 = ivals[0][0] / 1e3
    pairs = [((s / 1e3 - x0, e / 1e3 - x0), k) for (s, e), k in zip(ivals, ks)]
    rate = 1.0
    lo, hi = _bracket(pairs, rate)
    third = len(pairs) // 3
    if third:
        first, last = pairs[:third], pairs[-third:]
        (l1, h1), (l3, h3) = _bracket(first, rate), _bracket(last, rate)
        if abs((l3 + h3) / 2 - (l1 + h1) / 2) > max(hi - lo, 0.0):
            mid_x = [sum((ss + se) / 2 for (ss, se), _ in p) / len(p) for p in (first, last)]
            if mid_x[1] > mid_x[0]:
                guess = rate + ((l3 + h3) / 2 - (l1 + h1) / 2) / (mid_x[1] - mid_x[0])
                rate = _widest_rate(pairs, guess)
                lo, hi = _bracket(pairs, rate)
    if hi < lo:
        return None
    return Fit(offset_us=(lo + hi) / 2, rate=rate, x0_us=x0, width_us=hi - lo)


def job_fits(records, ops) -> Dict[object, Fit]:
    """{job: fit} from the records' ``pairhmm.device`` spans (all of
    them: the traced window holds every job that made one) and the
    trace's PairHMM kernels. Jobs run one after another, so the kernels,
    in order, split among the jobs by each one's launches; each job's
    spans are fitted to its own kernels. Unequal counts in all give no
    fit; a job whose own bracket is empty is left out."""
    by_job: Dict[object, list] = {}
    for s in sorted((s for s in records.all_spans if s["name"] == "pairhmm.device"),
                    key=lambda s: s["start"]):
        by_job.setdefault(s["job"], []).append(
            (s["start"], s["end"], int((s["attrs"] or {}).get("launches", 1))))
    kernels = sorted((ts, d) for name, cat, ts, d in ops if cat == "kernel" and "pairhmm" in name)
    if sum(k for sp in by_job.values() for _, _, k in sp) != len(kernels):
        return {}
    out, at = {}, 0
    for job, sp in by_job.items():
        n = sum(k for _, _, k in sp)
        f = fit(sp, kernels[at : at + n])
        at += n
        if f is not None:
            out[job] = f
    return out


def total(ivals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in ivals)


def union(ivals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys) -> List[Tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(ivals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """[lo, hi] less the union of ``ivals``."""
    out, cur = [], lo
    for a, b in union(ivals):
        if b <= cur:
            continue
        if a >= hi:
            break
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out
