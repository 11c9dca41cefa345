"""device_ops.roofline_pct: the torch device programs' (duplicate marking,
sort, BQSR table build and apply) share of their bytes bound in the
traced window: the bytes that the jobs' reads make them move at the
least (roofline.device_programs_bytes) at the card's peak rate, over the
profiler's device time of every kernel that is not the PairHMM's. The
traced span runs to the end of the job that overran the window, so that
job's bytes count with those of the jobs completed in it."""

import roofline


def read(rec):
    ops = [o for o in rec.get("trace", {}).get("ops", [])
           if o[1] == "kernel" and "pairhmm" not in o[0]]
    device_s = sum(d for _, _, _, d in ops) / 1e6
    n_jobs = sum(j["rc"] == 0 for j in rec["jobs"] + [rec.get("late") or {"rc": 1}])
    if device_s <= 0 or not n_jobs:
        return None
    nbytes = n_jobs * roofline.device_programs_bytes(rec["n_reads"], rec["read_length"],
                                                     rec["dup_share"])
    return 100.0 * roofline.bytes_bound_s(nbytes) / device_s
