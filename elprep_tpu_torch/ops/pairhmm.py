"""PairHMM read-vs-haplotype likelihoods.

Reference: filters/pairhmm.go — a float64 forward algorithm over three
matrices (match/insertion/deletion) with row-view inner loops
(:180-320). This module provides three implementations:

1. ``pairhmm_exact`` — scalar float64 with the reference's exact
   operation order (oracle + pedantic path);
2. ``pairhmm_f64_diag`` — numpy float64 anti-diagonal wavefront,
   vectorized along the diagonal (host production / rescue path);
3. ``pairhmm_f32_batch`` — float32 wavefront batched over (read,
   haplotype) pairs: the hand-written Hopper kernel on ``cuda``, its
   plain PyTorch version on the CPU (ops/pairhmm_cuda.py). Pairs whose
   f32 result underflows are re-run through the f64 path, mirroring
   GATK's float-with-double-rescue strategy.

The anti-diagonal formulation: every cell (i, j) with i+j = d depends
only on diagonals d-1 and d-2, so all cells of one diagonal are
independent, replacing the reference's per-cell scalar loop.

Transition coefficients are indexed by the *destination* row's read
base: matchToMatch/matchToIndel from tandem-repeat length
(pairhmm.go:104-162), indelToIndel = 0.1. Priors use
modifiedQuality = min(QUAL, MAPQ) with <18 -> 6 (pairhmm.go:77-86).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .. import device as _device
from .. import trace
from ..hc import tables

F32_INITIAL_POW = 100  # 2^100 fits float32 with headroom
F32_RESCUE_LOG10 = -25.0  # below this, recompute in f64 (underflow risk)


# ---------------------------------------------------------------------------
# Tandem repeats & per-base transition probabilities (pairhmm.go:88-162)
# ---------------------------------------------------------------------------


def _n_forward_reps(unit: bytes, s: bytes) -> int:
    n = 0
    ul = len(unit)
    while len(s) >= ul and s.startswith(unit):
        n += 1
        s = s[ul:]
    return n


def _n_backward_reps(unit: bytes, s: bytes) -> int:
    n = 0
    ul = len(unit)
    while len(s) >= ul and s.endswith(unit):
        n += 1
        s = s[: len(s) - ul]
    return n


def find_tandem_repeat_units(bases: bytes, offset: int) -> Tuple[bytes, int]:
    """(reference: pairhmm.go:104-153)"""
    offset1 = offset + 1
    max_bw = 0
    best_bw_unit = bases[offset:offset1]
    bw_test = bases[:offset1]
    for strlen in range(1, 9):
        repeat_offset = offset1 - strlen
        if repeat_offset < 0:
            break
        unit = bases[repeat_offset:offset1]
        max_bw = _n_backward_reps(unit, bw_test)
        if max_bw > 1:
            best_bw_unit = unit
            break
    best_unit = best_bw_unit
    max_rl = max_bw

    if offset1 < len(bases):
        max_fw = 0
        best_fw_unit = bases[offset1 : offset1 + 1]
        fw_test = bases[offset1:]
        for strlen in range(1, 9):
            repeat_offset = offset1 + strlen
            if repeat_offset > len(bases):
                break
            unit = bases[offset1:repeat_offset]
            max_fw = _n_forward_reps(unit, fw_test)
            if max_fw > 1:
                best_fw_unit = unit
                break
        if best_fw_unit != best_bw_unit:
            max_bw = _n_backward_reps(best_fw_unit, bases[:offset1])
        max_rl = max_fw + max_bw
        best_unit = best_fw_unit

    if max_rl > 20:
        max_rl = 20
    return best_unit, max_rl


def repeat_lengths_for_read(bases: bytes) -> np.ndarray:
    """Per-base tandem-repeat length, 21 sentinel on the last base
    (reference: pairhmm.go:155-162) — the uint8 form shipped to the
    device, which derives the transition probabilities by table lookup.
    Native fast path (C++ pairhmm_repeat_lengths; the loop below is its
    fuzzed oracle)."""
    from .. import native

    got = native.pairhmm_repeat_lengths(bases)
    if got is not None:
        return got
    return _repeat_lengths_for_read_py(bases)


def _repeat_lengths_for_read_py(bases: bytes) -> np.ndarray:
    n = len(bases)
    rl = np.empty(n, np.uint8)
    for i in range(n - 1):
        _, r = find_tandem_repeat_units(bases, i)
        rl[i] = r
    if n:
        rl[n - 1] = 21
    return rl


def match_probs_for_read(bases: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Per-base (matchToMatch, matchToIndel) (reference: pairhmm.go:155-162)."""
    rl = repeat_lengths_for_read(bases)
    return tables.MATCH_TO_MATCH[rl], tables.MATCH_TO_INDEL[rl]


def modified_qualities(qual: np.ndarray, mapq: int) -> np.ndarray:
    """(reference: pairhmm.go:77-86)"""
    q = np.minimum(qual.astype(np.int64), mapq)
    return np.where(q < 18, 6, q)


# ---------------------------------------------------------------------------
# 1. Exact scalar oracle (reference operation order)
# ---------------------------------------------------------------------------


def pairhmm_exact(seq: bytes, qual: np.ndarray, mapq: int, hap: bytes) -> float:
    """Bit-exact float64 forward pass in the reference's evaluation order
    (pairhmm.go:225-295). O(len(seq)*len(hap)) scalar — oracle use only."""
    lr, lh = len(qual), len(hap)
    m2m_arr, m2i_arr = match_probs_for_read(seq)
    mq = modified_qualities(qual, mapq)
    match = np.zeros((lr + 1, lh + 1), np.float64)
    ins = np.zeros((lr + 1, lh + 1), np.float64)
    dele = np.zeros((lr + 1, lh + 1), np.float64)
    initial = tables.INITIAL_CONDITION / float(lh)
    dele[0, :] = initial
    i2m = tables.INDEL_TO_MATCH
    i2i = tables.INDEL_TO_INDEL
    for i in range(lr):
        x = seq[i]
        ep = tables.QUAL_TO_ERROR_PROB[mq[i]]
        match_prior = 1.0 - ep
        non_match_prior = ep / 3.0
        m2m = m2m_arr[i]
        m2i = m2i_arr[i]
        for j in range(lh):
            y = hap[j]
            prior = match_prior if (x == y or x == ord("N") or y == ord("N")) else non_match_prior
            match[i + 1, j + 1] = prior * (
                match[i, j] * m2m + ins[i, j] * i2m + dele[i, j] * i2m
            )
            ins[i + 1, j + 1] = match[i, j + 1] * m2i + ins[i, j + 1] * i2i
            dele[i + 1, j + 1] = match[i + 1, j] * m2i + dele[i + 1, j] * i2i
    s = 0.0
    for j in range(1, lh + 1):
        s += match[lr, j] + ins[lr, j]
    return float(np.log10(s) - tables.INITIAL_CONDITION_LOG10)


# ---------------------------------------------------------------------------
# 2. Vectorized f64 wavefront (numpy, host)
# ---------------------------------------------------------------------------


def pairhmm_f64_diag(seq: bytes, qual: np.ndarray, mapq: int, hap: bytes) -> float:
    """Same result as pairhmm_exact up to f64 addition reordering along
    the diagonal (the per-cell products/sums keep the reference order;
    only the independent cells run as vector ops)."""
    lr, lh = len(qual), len(hap)
    m2m_a, m2i_a = match_probs_for_read(seq)
    mq = modified_qualities(qual, mapq)
    ep = tables.QUAL_TO_ERROR_PROB[mq]
    match_prior = 1.0 - ep
    non_match_prior = ep / 3.0
    # row-aligned (index i = matrix row, read base i-1); row 0 unused
    m2m = np.concatenate([[0.0], m2m_a])
    m2i = np.concatenate([[0.0], m2i_a])
    mp = np.concatenate([[0.0], match_prior])
    nmp = np.concatenate([[0.0], non_match_prior])
    x = np.concatenate([[0], np.frombuffer(seq, np.uint8)]).astype(np.int16)
    i2m = tables.INDEL_TO_MATCH
    i2i = tables.INDEL_TO_INDEL
    initial = tables.INITIAL_CONDITION / float(lh)

    hap_arr = np.frombuffer(hap, np.uint8).astype(np.int16)
    P = lr + 2
    rev_pad = np.zeros(P + lh + P, np.int16)
    rev_pad[P : P + lh] = hap_arr[::-1]

    n = lr + 1
    idx = np.arange(n)
    Md1 = np.zeros(n); Md2 = np.zeros(n)
    Id1 = np.zeros(n); Id2 = np.zeros(n)
    Dd1 = np.zeros(n); Dd2 = np.zeros(n)
    Dd1[0] = initial  # diagonal d=0: cell (0,0)
    acc = 0.0
    for d in range(1, lr + lh + 1):
        hb = rev_pad[P + lh - d : P + lh - d + n]
        is_match = (x == hb) | (x == ord("N")) | (hb == ord("N"))
        prior = np.where(is_match, mp, nmp)
        Ms2 = np.concatenate([[0.0], Md2[:-1]])
        Is2 = np.concatenate([[0.0], Id2[:-1]])
        Ds2 = np.concatenate([[0.0], Dd2[:-1]])
        Ms1 = np.concatenate([[0.0], Md1[:-1]])
        Is1 = np.concatenate([[0.0], Id1[:-1]])
        M_cur = prior * (Ms2 * m2m + Is2 * i2m + Ds2 * i2m)
        I_cur = Ms1 * m2i + Is1 * i2i
        D_cur = Md1 * m2i + Dd1 * i2i
        valid = idx <= d - 1  # j = d - i >= 1
        M_cur = np.where(valid, M_cur, 0.0)
        I_cur = np.where(valid, I_cur, 0.0)
        D_cur = np.where(valid, D_cur, 0.0)
        M_cur[0] = 0.0
        I_cur[0] = 0.0
        D_cur[0] = initial
        j_final = d - lr
        if 1 <= j_final <= lh:
            acc += M_cur[lr] + I_cur[lr]
        Md2, Id2, Dd2 = Md1, Id1, Dd1
        Md1, Id1, Dd1 = M_cur, I_cur, D_cur
    return float(np.log10(acc) - tables.INITIAL_CONDITION_LOG10)


# ---------------------------------------------------------------------------
# 3. Batched f32 wavefront (the Hopper kernel, ops/pairhmm_cuda.py)
# ---------------------------------------------------------------------------


# the session's PairHMM mesh (parallel/mesh.py; the CLI sets it for
# --sharded): when set, a dispatch on the session device splits its pair
# axis over the mesh's devices instead
_MESH: list = [None]


def set_pairhmm_mesh(mesh) -> None:
    """Set (a sequence of devices) or clear (None) the PairHMM mesh."""
    _MESH[0] = None if mesh is None else tuple(mesh)


def pairhmm_logl_pairs(
    reads: Sequence[Tuple[bytes, np.ndarray, int]],
    haps: Sequence[bytes],
    pair_r: np.ndarray,
    pair_h: np.ndarray,
    device=None,
) -> np.ndarray:
    """log10 likelihood per explicit (read, hap) pair — the cross-region
    batch entry (pairs from many assembly regions share ONE device
    dispatch). f32 wavefront with f64 host rescue: a pair whose f32 value
    underflows or falls below F32_RESCUE_LOG10 is recomputed by
    ``pairhmm_f64_diag`` (GATK's float-then-double strategy). The f32
    backend is the kernel on ``cuda``, its plain version on ``cpu``.
    ``device`` is one device or a sequence of them (a mesh, one contiguous
    chunk of pairs per entry); ``None``: the session's PairHMM mesh when
    one is set, else the session default."""
    from . import pairhmm_cuda

    if len(pair_r) == 0:
        return np.zeros(0, np.float64)
    if device is None and _MESH[0] is not None:
        device = _MESH[0]
    devices = tuple(_device.resolve(d) for d in (
        device if isinstance(device, (list, tuple)) else (device,)))
    acc = pairhmm_cuda.pairhmm_pairs(reads, haps, pair_r, pair_h, devices)
    with np.errstate(divide="ignore"):
        out = np.log10(acc.astype(np.float64)) - F32_INITIAL_POW * np.log10(2.0)
    bad = ~np.isfinite(out) | (out < F32_RESCUE_LOG10)
    with trace.span("pairhmm.rescue"):
        for b in np.flatnonzero(bad):
            seq, qual, mapq = reads[int(pair_r[b])]
            out[b] = pairhmm_f64_diag(seq, qual, mapq, haps[int(pair_h[b])])
    return out


def pairhmm_f32_batch(
    reads: Sequence[Tuple[bytes, np.ndarray, int]],
    haps: Sequence[bytes],
    device=None,
) -> np.ndarray:
    """log10 likelihoods [n_reads, n_haps] — full cross product of one
    region (wrapper over :func:`pairhmm_logl_pairs`)."""
    n_reads, n_haps = len(reads), len(haps)
    if n_reads == 0 or n_haps == 0:
        return np.zeros((n_reads, n_haps), np.float64)
    pair_r = np.repeat(np.arange(n_reads), n_haps)
    pair_h = np.tile(np.arange(n_haps), n_reads)
    return pairhmm_logl_pairs(reads, haps, pair_r, pair_h,
                              device).reshape(n_reads, n_haps)


# ---------------------------------------------------------------------------
# Driver-level likelihood computation (pairhmm.go:180-320)
# ---------------------------------------------------------------------------


def compute_read_likelihoods(
    reads: Sequence[Tuple[bytes, np.ndarray, int]],
    haps: Sequence[bytes],
    hap_is_ref: Sequence[bool],
    use_device: bool = True,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values [n_haps, n_reads], keep_mask [n_reads]) applying the
    best-likelihood cap (pairhmm.go:297-316) and poorly-modeled-read
    removal (pairhmm.go:318-334)."""
    n_reads, n_haps = len(reads), len(haps)
    if use_device:
        vals = pairhmm_f32_batch(reads, haps, device).T.copy()  # [H, N]
    else:
        vals = np.empty((n_haps, n_reads), np.float64)
        for h in range(n_haps):
            for r in range(n_reads):
                seq, qual, mapq = reads[r]
                vals[h, r] = pairhmm_f64_diag(seq, qual, mapq, haps[h])
    return _cap_and_filter(vals, reads, hap_is_ref)


def _cap_and_filter(vals: np.ndarray,
                    reads: Sequence[Tuple[bytes, np.ndarray, int]],
                    hap_is_ref: Sequence[bool]) -> Tuple[np.ndarray, np.ndarray]:
    """Best-likelihood cap (pairhmm.go:297-316) + poorly-modeled-read
    removal (pairhmm.go:318-334). vals is [n_haps, n_reads]."""
    n_haps, n_reads = vals.shape
    if n_haps > 1:
        nonref = ~np.asarray(hap_is_ref, bool)
        if nonref.any():
            best = np.max(vals[nonref, :], axis=0)
            cap = best + tables.GLOBAL_READ_MISMAPPING_RATE
            finite = np.isfinite(best)
            vals = np.where(finite[None, :], np.maximum(vals, cap[None, :]), vals)

    keep = np.ones(n_reads, bool)
    for r in range(n_reads):
        max_errors = min(2.0, np.ceil(len(reads[r][1]) * 0.02))
        threshold = max_errors * -4.0
        keep[r] = bool(np.any(vals[:, r] >= threshold))
    return vals[:, keep], keep


def compute_read_likelihoods_multi(
    workloads: Sequence[Tuple[Sequence[Tuple[bytes, np.ndarray, int]],
                              Sequence[bytes], Sequence[bool]]],
    use_device: bool = True,
    device=None,
) -> list:
    """Batched :func:`compute_read_likelihoods` over several assembly
    regions: all (read, hap) pairs share ONE device dispatch (per-region
    dispatch latency dominated HC wall time on high-latency links).
    Returns a list of (values, keep) in workload order. Results are
    identical to per-region calls — the wavefront kernel is
    padding-invariant, so group-level shape buckets do not change any
    pair's value."""
    if not use_device:
        return [compute_read_likelihoods(r, h, ref, use_device=False)
                for r, h, ref in workloads]
    all_reads: list = []
    all_haps: list = []
    pair_r: list = []
    pair_h: list = []
    spans = []
    p_off = 0
    for reads, haps, _ in workloads:
        nr, nh = len(reads), len(haps)
        r0, h0 = len(all_reads), len(all_haps)
        all_reads.extend(reads)
        all_haps.extend(haps)
        for r in range(nr):
            base = r0 + r
            for h in range(nh):
                pair_r.append(base)
                pair_h.append(h0 + h)
        spans.append((p_off, nr, nh))
        p_off += nr * nh
    logl = pairhmm_logl_pairs(all_reads, all_haps,
                              np.asarray(pair_r, np.int64),
                              np.asarray(pair_h, np.int64), device)
    out = []
    for (reads, haps, hap_is_ref), (off, nr, nh) in zip(workloads, spans):
        if nr == 0 or nh == 0:
            out.append((np.zeros((nh, 0), np.float64), np.zeros(nr, bool)))
            continue
        vals = logl[off : off + nr * nh].reshape(nr, nh).T.copy()
        out.append(_cap_and_filter(vals, reads, hap_is_ref))
    return out
