"""pairhmm.pairs_per_launch: pairs packed for the PairHMM in the traced
window over its kernel launches there (pairhmm_cuda.LAUNCHES_BY_PATH)."""


def read(rec):
    launches = sum(rec["launches"].values())
    pairs = sum(b["pairs"] for b in rec["pair_batches"])
    return pairs / launches if launches and pairs else None
