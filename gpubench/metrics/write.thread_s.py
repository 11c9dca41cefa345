"""write.thread_s: mean seconds per job of the BAM write (the program's
``write.bam`` span, on the output-writer thread beside the
HaplotypeCaller, which phase.write_s cannot see), over the jobs completed
in the traced window (spans.py)."""

import spans


def read(rec):
    r = spans.load(rec)
    return None if r is None else r.seconds_per_job("write.bam")
