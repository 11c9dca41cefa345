"""hc.main_busy_s: mean seconds per job in which the main thread was not
blocked in the HaplotypeCaller phase: the program's ``phase.hc`` span
less the main thread's ``hc.wait`` spans inside it (waiting on the
worker pool with nothing to read), over the jobs completed in the traced
window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None:
        return None

    def busy(job):
        hc = r.on_main_thread("phase.hc", job)
        if not hc:
            return None
        a, b = hc[0]["start"], hc[0]["end"]
        wait = sum(max(0, min(s["end"], b) - max(s["start"], a))
                   for s in r.on_main_thread("hc.wait", job))
        return (b - a - wait) / 1e9

    return r.mean(busy)
