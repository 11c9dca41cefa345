"""hc.recv_s: mean seconds per job that the main thread spent reading and
unpickling the worker pool's messages (the program's ``hc.recv`` spans on
the thread that ran the job), over the jobs completed in the traced
window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None or not any(r.on_main_thread("hc.recv", j) for j in r.jobs):
        return None
    return r.mean(lambda j: sum(s["end"] - s["start"]
                                for s in r.on_main_thread("hc.recv", j)) / 1e9)
