"""GATK-compatible numeric tables, computed from their generating
formulas (the reference vendors ~80k lines of float literals for the
same values: filters/haplotypecaller-tables.go; usage sites
filters/pairhmm.go:86-162, filters/haploutils.go:160-200,
filters/haplotypecaller.go:286-299).

All tables are float64 and bit-identical to the vendored ones (verified
by tests/test_hc_tables.py against the reference file):

- ``QUAL_TO_ERROR_PROB[q]`` = 10^(-q/10)
- ``QUAL_TO_ERROR_PROB_LOG10[q]`` = -q/10
- ``QUAL_TO_PROB_LOG10[q]`` = log10(1 - 10^(-q/10))
- ``MATCH_TO_INDEL[rl]`` = 10^(-gop(rl)/10) per tandem-repeat length,
  the conservative PCR indel error model's gap-open quality
  (45 for the no-info sentinel rl=21)
- ``MATCH_TO_MATCH[rl]`` = 1 - 2*MATCH_TO_INDEL[rl]
- ``JACOBIAN_LOG_TABLE[i]`` = log10(1 + 10^(-i*1e-4)), i*1e-4 <= 8
- ``GAUSSIAN_KERNEL`` = sum-normalized Gaussian, sigma=17, radius 50
"""

from __future__ import annotations

import os

import numpy as np

MAX_QUAL = 254

_CACHE = os.path.join(os.path.dirname(__file__), "_tables_cache.npz")


def _generate_exact():
    """Correctly-rounded table generation (numpy's libm pow/log10 can be
    1 ulp off the values the reference vendors; mpmath at high precision
    on the double-rounded arguments reproduces them bit-exactly)."""
    from mpmath import mp, mpf, log10 as mlog10, power

    mp.prec = 120
    # every intermediate is rounded to double, mirroring the Java chain
    # log10(1.0 - pow(10, q/-10.0)) / log10(1.0 + pow(10, -i*step))
    q2e = np.empty(MAX_QUAL + 1, np.float64)
    q2p = np.empty(MAX_QUAL + 1, np.float64)
    for q in range(MAX_QUAL + 1):
        d = float(q) / -10.0
        err = float(power(mpf(10), mpf(d)))
        q2e[q] = err
        one_minus = 1.0 - err  # double-rounded subtraction
        q2p[q] = float(mlog10(mpf(one_minus))) if one_minus > 0.0 else -np.inf
    njac = int(JACOBIAN_LOG_MAX_TOLERANCE / JACOBIAN_LOG_STEP) + 1
    jac = np.empty(njac, np.float64)
    for i in range(njac):
        x = float(i) * JACOBIAN_LOG_STEP
        p = float(power(mpf(10), mpf(-x)))
        jac[i] = float(mlog10(mpf(1.0 + p)))
    return q2e, q2p, jac


def _load_tables():
    if os.path.exists(_CACHE):
        z = np.load(_CACHE)
        return z["q2e"], z["q2p"], z["jac"]
    q2e, q2p, jac = _generate_exact()
    try:
        np.savez(_CACHE, q2e=q2e, q2p=q2p, jac=jac)
    except OSError:
        pass
    return q2e, q2p, jac


# approximateLog10SumLog10 support (reference: haploutils.go:160-200)
JACOBIAN_LOG_STEP = 1e-4
JACOBIAN_LOG_MAX_TOLERANCE = 8.0

QUAL_TO_ERROR_PROB, QUAL_TO_PROB_LOG10, JACOBIAN_LOG_TABLE = _load_tables()
_q = np.arange(MAX_QUAL + 1, dtype=np.float64)
QUAL_TO_ERROR_PROB_LOG10 = _q / -10.0

# Gap-open quality per tandem-repeat length 0..20 (PCR conservative
# model); index 21 is the "no repeat info" default of 45 used for the
# last base of a read (reference: pairhmm.go:155-162).
_GOP_BY_REPEAT_LENGTH = np.array(
    [40, 40, 40, 40, 39, 39, 39, 39, 39, 38, 38, 38, 37, 37, 37, 36, 36,
     35, 34, 33, 33, 45],
    dtype=np.float64,
)
MATCH_TO_INDEL = np.power(10.0, _GOP_BY_REPEAT_LENGTH / -10.0)
MATCH_TO_MATCH = 1.0 - 2.0 * MATCH_TO_INDEL

# indel continuation (reference: pairhmm.go:167-170)
INDEL_TO_INDEL = float(QUAL_TO_ERROR_PROB[10])  # 0.1
INDEL_TO_MATCH = 1.0 - INDEL_TO_INDEL

INITIAL_CONDITION = float(2.0 ** 1020)
INITIAL_CONDITION_LOG10 = float(np.log10(2.0 ** 1020))

GLOBAL_READ_MISMAPPING_RATE = 45 / -10.0  # (pairhmm.go:172)



def _gaussian_kernel(sigma: float = 17.0, radius: int = 50) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


GAUSSIAN_KERNEL = _gaussian_kernel()


def jacobian_index(diff: np.ndarray) -> np.ndarray:
    """Clamped JACOBIAN_LOG_TABLE index for vectorized
    approximate_log10_sum_log10. Non-finite diffs (from -inf operands,
    whose lanes the caller masks to `big` anyway) map to 0 instead of
    casting inf→int64-min and faulting the gather."""
    idx_f = np.round(diff / JACOBIAN_LOG_STEP)
    idx_f = np.where(np.isfinite(idx_f), idx_f, 0.0)
    return np.minimum(idx_f, len(JACOBIAN_LOG_TABLE) - 1).astype(np.int64)


def approximate_log10_sum_log10(a: float, b: float) -> float:
    """(reference: haploutils.go:171-200)"""
    if a > b:
        big, small = a, b
    else:
        big, small = b, a
    if np.isinf(small) and small < 0:
        return big
    diff = big - small
    if diff >= JACOBIAN_LOG_MAX_TOLERANCE:
        return big
    return big + float(JACOBIAN_LOG_TABLE[int(round(diff / JACOBIAN_LOG_STEP))])


def approximate_log10_sum_log10_array(vals) -> float:
    """Left fold of the pairwise approximation (GATK semantics)."""
    acc = float("-inf")
    for v in vals:
        acc = approximate_log10_sum_log10(acc, float(v))
    return acc
