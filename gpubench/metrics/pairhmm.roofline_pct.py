"""pairhmm.roofline_pct: the PairHMM kernels' share of their roofline in
the traced window. Σ over batches of the larger of the operations bound
(11 float32 operations per read x haplotype cell of the pairs as sent)
and the bytes bound (packed inputs read once, outputs written once), over
the profiler's device time of the pairhmm_*kernel launches."""

import roofline


def read(rec):
    ops = [o for o in rec.get("trace", {}).get("ops", []) if "pairhmm" in o[0]]
    device_s = sum(d for _, _, _, d in ops) / 1e6
    if device_s <= 0 or not rec["pair_batches"]:
        return None
    bound = sum(roofline.pairhmm_bound_s(b["cells"], b["bytes"], b["pairs"])
                for b in rec["pair_batches"])
    return 100.0 * bound / device_s
