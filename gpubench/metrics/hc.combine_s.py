"""hc.combine_s: mean seconds per job of the GVCF combiner thread's work
(the program's ``hc.combine`` spans, one per region batch and flush),
over the jobs completed in the traced window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    return None if r is None else r.seconds_per_job("hc.combine")
