"""hc.worker_sw_s: mean seconds per job of Smith-Waterman alignments in
the HaplotypeCaller (the program's ``hc.sw`` counter, summed over every
worker process and thread), over the jobs completed in the traced window
(spans.py). The native assembly engine's own alignments are not
counted."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None:
        return None
    ns = {}
    for c in r.counters:
        if c["name"] == "hc.sw":
            ns[c["job"]] = ns.get(c["job"], 0) + c["ns"]
    if not ns:
        return None
    return r.mean(lambda j: ns.get(j, 0) / 1e9)
