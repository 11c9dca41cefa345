"""phase.read_s: mean seconds per job of the program's --timed read phase (parse, duplicate marking, sort)
(cli._timed), over the jobs completed in the traced window."""

PHASES = ("Reading SAM into memory and applying filters.",)


def read(rec):
    per_job = [sum(s for name, s in job["phases"] if name in PHASES)
               for job in rec["jobs"] if job["rc"] == 0
               and any(name in PHASES for name, _ in job["phases"])]
    return sum(per_job) / len(per_job) if per_job else None
