"""pairhmm.batch_wait_ms: mean milliseconds, over the regions sent to the
PairHMM, from the receipt of their prepare result in the main process to
the start of their batch's ``pairhmm.device`` span (the program's
``pairhmm.batch`` attributes ``wait_sum_ns`` and ``regions``), over the
jobs completed in the traced window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None:
        return None
    batches = [s["attrs"] for j in r.jobs for s in r.named("pairhmm.batch", j)
               if s["attrs"] and "wait_sum_ns" in s["attrs"]]
    regions = sum(a["regions"] for a in batches)
    return sum(a["wait_sum_ns"] for a in batches) / regions / 1e6 if regions else None
