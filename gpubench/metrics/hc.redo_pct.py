"""hc.redo_pct: the share, in percent, of the HaplotypeCaller pool's
speculative genotypes that the ordered consumer sent back to be redone
under the true deletions carry: the ``worker.redo`` spans over the
``worker.geno`` spans of a job (every worker process summed), times 100,
the mean over the jobs completed in the traced window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    if r is None:
        return None

    def pct(job):
        geno = len(r.named("worker.geno", job))
        return 100.0 * len(r.named("worker.redo", job)) / geno if geno else None

    return r.mean(pct)
