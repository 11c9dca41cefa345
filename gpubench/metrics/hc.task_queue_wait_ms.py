"""hc.task_queue_wait_ms: mean milliseconds that a prepare task waited
between its send in the main process and its start in a worker (each
``worker.task`` span's start less the send stamp it carries; one clock in
every process), over the tasks of the jobs completed in the traced
window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None:
        return None
    waits = [s["start"] - s["attrs"]["sent"] for j in r.jobs for s in r.named("worker.task", j)
             if s["attrs"] and s["attrs"].get("sent") is not None]
    return sum(waits) / len(waits) / 1e6 if waits else None
