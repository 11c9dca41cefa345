"""pairhmm.pack_s: mean seconds per job of the PairHMM's host packing on
the dispatch thread (the program's ``pairhmm.pack`` spans), over the jobs
completed in the traced window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    return None if r is None else r.seconds_per_job("pairhmm.pack")
