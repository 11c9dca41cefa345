"""hc.worker_busy_pct: the HaplotypeCaller pool's workers' CPU seconds over
the traced window (HCWorkerPool.probe_workers(), before and after) as a
share of workers x the summed wall of the jobs' HC phases. The probe
after the window comes after the job that overran it, so that job's HC
phase counts with those of the jobs completed in the window."""


def read(rec):
    hc = sum(s for job in rec["jobs"] + [rec.get("late") or {"rc": 1}] if job["rc"] == 0
             for name, s in job["phases"] if name == "Calling variants.")
    if not rec["workers"] or hc <= 0:
        return None
    return 100.0 * rec["worker_cpu_s"] / (rec["workers"] * hc)
