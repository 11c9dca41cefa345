"""pairhmm.pending_idle_pct: of the card's idle time inside the
HaplotypeCaller phases (``phase.hc`` spans) of the jobs completed in the
traced window, the share during which PairHMM inputs were pending: from
the first receipt of a batch's prepare results (its ``pairhmm.device``
start less its ``wait_max_ns``) to that device start. Idle is the
complement of the union of the profiler's device operations, mapped onto
the program's clock by each job's own bracket fit (spanclock.job_fits);
a job without a fit counts in neither part, and no fit in any job gives
no reading."""

import bisect

import spanclock
import spans


def read(rec):
    r = spans.load(rec)
    raw = (rec.get("trace") or {}).get("ops") or []
    if r is None or not raw:
        return None
    fits = spanclock.job_fits(r, raw)
    ops = sorted((ts, d) for _, _, ts, d in raw)
    starts = [ts for ts, _ in ops]
    longest = max(d for _, d in ops)
    idle, pending = [], []
    for j in r.jobs:
        fit = fits.get(j)
        if fit is None:
            continue
        for hc in r.on_main_thread("phase.hc", j):
            lo, hi = fit.to_trace(hc["start"]), fit.to_trace(hc["end"])
            near = ops[bisect.bisect_left(starts, lo - longest) : bisect.bisect_right(starts, hi)]
            busy = spanclock.union((fit.to_program(ts), fit.to_program(ts + d)) for ts, d in near)
            idle += spanclock.complement(busy, hc["start"], hc["end"])
        for b in r.named("pairhmm.batch", j):
            dev = r.children(b, "pairhmm.device")
            if dev and b["attrs"] and "wait_max_ns" in b["attrs"]:
                start = dev[0]["start"]
                pending.append((start - b["attrs"]["wait_max_ns"], start))
    idle_ns = spanclock.total(idle)
    if idle_ns <= 0:
        return None
    both = spanclock.intersect(spanclock.union(idle), spanclock.union(pending))
    return 100.0 * spanclock.total(both) / idle_ns
