"""BQSR device programs: per-base covariates + dense-table accumulation,
and the recalibration of the quals, as torch ops on the caller's device.

elPrep builds three hash tables keyed by {Qual, Covariate, ReadGroup}
via fork-join map merges (reference: filters/bqsr.go:180-223, 467-551).
Here the tables are *dense* arrays

    QualityScores: [nRG, 94]            (qual 0..93)
    Cycles:        [nRG, 94, 2*maxCycle+1]
    Contexts:      [nRG, 94, 16]        (2-mer b1*4+b2)

accumulated with integer scatter-adds over per-base index/error vectors.
Covariates are computed per base:

- cycle: strand/mate-signed base cycle (bqsr.go:376-386);
- context: rolling 2-mer key over the qual-tail-masked, strand-oriented
  sequence (bqsr.go:64-146, 301-362). For contextSize=2 the rolling
  machinery reduces to: forward reads key[i] = f(b[i-1], b[i]), reversed
  reads key[i] = f(comp(b[i+1]), comp(b[i])), key invalid (-1) when
  either base is outside the qual window or not ACGT;
- SNP events: per-base reference position from the CIGAR (cumulative
  read/ref-consumed lengths + a batched searchsorted), then one gather
  from the flattened reference class codes (bqsr.go:254-285).

Every function takes numpy arrays or tensors plus ``device=`` (``None``:
the session default) and returns tensors there. Index arithmetic runs in
int64 (quals and bases are widened from uint8 before any of it).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .readstats import CIGAR_OPS, OP_CLASS

MIN_INTERESTING_QUAL = 6  # (reference: bqsr.go:698)
LOW_QUALITY_TAIL = 2  # (reference: bqsr.go:301)
NQUAL = 94  # qual 0..93 (maxQualityScore, bqsr.go:555)
NCTX = 16

# seq char -> simple base index (A0 C1 G2 T3, else -1)
# (reference: bqsr.go:55-62; '*'/lowercase can't occur in normalized SEQ)
_BASE_IDX = np.full(256, -1, np.int32)
for _i, _c in enumerate(b"ACGT"):
    _BASE_IDX[_c] = _i
_BASE_IDX[ord("a")] = 0
_BASE_IDX[ord("c")] = 1
_BASE_IDX[ord("g")] = 2
_BASE_IDX[ord("t")] = 3
_BASE_IDX[ord("*")] = 0

# seq char -> baseToIntMap class (reference: bqsr.go:247-252)
_BASE_INT = np.zeros(256, np.int32)
for _b, _v in ((b"aA*", 1), (b"cC", 2), (b"gG", 3), (b"tT", 4)):
    for _c in _b:
        _BASE_INT[_c] = _v

_READ_CONS = np.zeros(len(CIGAR_OPS), np.int32)
for _c in b"MIS=X":
    _READ_CONS[OP_CLASS[_c]] = 1
_REF_CONS = np.zeros(len(CIGAR_OPS), np.int32)
for _c in b"MDN=X":
    _REF_CONS[OP_CLASS[_c]] = 1
_IS_MX = np.zeros(len(CIGAR_OPS), np.int32)
for _c in b"M=X":
    _IS_MX[OP_CLASS[_c]] = 1

REVERSED = 0x10
LAST = 0x80


def _t(a, dev: torch.device, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


# the constant tables above as int64 tensors, per (table, device): each is
# copied to a device once, so no later call copies from the host (a copy
# from pageable host memory cannot be captured into a CUDA graph)
_DEVICE_LUTS: dict = {}


def _lut(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    key = (id(table), idx.device)
    t = _DEVICE_LUTS.get(key)
    if t is None:
        t = _DEVICE_LUTS.setdefault(key, torch.as_tensor(table).to(
            device=idx.device, dtype=torch.int64))
    return t[idx]


def _cycle_covariates(flag, seq_len, L):
    """Per-base signed cycle (reference: bqsr.go:376-386). Returns [N, L]."""
    reversed_ = (flag & REVERSED) >> 4
    last = (flag & LAST) >> 7
    read_order_factor = 1 - 2 * last
    cycle_factor = read_order_factor + reversed_ * (seq_len - 1) * read_order_factor
    increment = (1 - 2 * reversed_) * read_order_factor
    idx = torch.arange(L, device=flag.device)[None, :]
    return cycle_factor[:, None] + idx * increment[:, None]


def _context_keys16(base, q, seq_len, flag, L):
    """Per-base 2-mer context as b1*4+b2 in 0..15, or -1 if invalid.

    Encodes computeStrandedClippedSeq + contextWith for contextSize=2
    (reference: bqsr.go:87-146, 312-362). ``base`` int64 codes, ``q``
    int64 quals. Returns [N, L] int64.
    """
    n = flag.shape[0]
    dev = flag.device
    cols = torch.arange(L, device=dev)[None, :]
    valid = cols < seq_len[:, None]
    bidx = _lut(_BASE_IDX, base)

    hq = valid & (q > LOW_QUALITY_TAIL)
    # leftPos = first hq index (or seq_len if none); rightPos = last hq index
    left_pos = torch.where(hq, cols, 2**30).amin(dim=1)
    right_pos = torch.where(hq, cols, -1).amax(dim=1)
    in_window = (cols >= left_pos[:, None]) & (cols <= right_pos[:, None])
    # base value as seen by contextWith ('N' outside window)
    b = torch.where(in_window & (bidx >= 0), bidx, -1)

    is_rev = ((flag & REVERSED) != 0)[:, None]
    comp = torch.where(b >= 0, 3 - b, -1)

    # forward: (b[i-1], b[i]); reversed: (comp(b[i+1]), comp(b[i]))
    pad = torch.full((n, 1), -1, dtype=b.dtype, device=dev)
    b_prev = torch.cat([pad, b[:, :-1]], dim=1)
    c_next = torch.cat([comp[:, 1:], pad], dim=1)
    # reversed reads: position L'-1 must be invalid (key_rc[0] = -1)
    last_col = cols == (seq_len - 1)[:, None]

    b1 = torch.where(is_rev, c_next, b_prev)
    b2 = torch.where(is_rev, comp, b)
    bad = (b1 < 0) | (b2 < 0) | ~valid
    bad = bad | torch.where(is_rev, last_col, cols == 0)
    return torch.where(bad, -1, b1 * 4 + b2)


def _per_base_refpos_and_mx(pos, op_class, op_len, L):
    """For each read base i: (global-less) reference position pos-1+offset,
    and whether the covering op is M/=/X. Returns (refpos [N,L] int64,
    is_mx [N,L] bool, covered [N,L] bool)."""
    rc = _lut(_READ_CONS, op_class) * op_len
    fc = _lut(_REF_CONS, op_class) * op_len
    read_incl = torch.cumsum(rc, dim=1)
    ref_excl = torch.cumsum(fc, dim=1) - fc
    read_excl = read_incl - rc

    # [N, L] column indices, contiguous as searchsorted requires
    cols = torch.arange(L, device=pos.device).expand(pos.shape[0], L).contiguous()
    # op index covering base i: first k with read_incl[k] > i
    k = torch.searchsorted(read_incl, cols, right=True)
    k = torch.clamp(k, max=op_class.shape[1] - 1)
    covered = cols < read_incl[:, -1:]
    off_in_op = cols - torch.gather(read_excl, 1, k)
    refpos = (pos - 1)[:, None] + torch.gather(ref_excl, 1, k) + off_in_op
    opk = torch.gather(op_class, 1, k)
    is_mx = _lut(_IS_MX, opk) > 0
    return refpos, is_mx & covered, covered


def _covariate_codes(base, qual, seq_len, flag, pos, rg, refoff, skip,
                     op_class, op_len, ref_classes, max_cycle: int,
                     n_rg: int, dev: torch.device):
    """Shared elementwise prelude of the table build: per-base flat table
    indices (sentinel = table size for masked elements), the mismatch
    indicator, and the cycle-range check value."""
    base, qual = _t(base, dev), _t(qual, dev)
    seq_len, flag, pos, rg = (_t(a, dev) for a in (seq_len, flag, pos, rg))
    refoff = _t(refoff, dev)
    skip = _t(skip, dev, torch.bool)
    op_class, op_len = _t(op_class, dev), _t(op_len, dev)
    ref_classes = _t(ref_classes, dev)
    N, L = base.shape
    valid = torch.arange(L, device=dev)[None, :] < seq_len[:, None]

    bidx = _lut(_BASE_IDX, base)
    q = qual

    cycles = _cycle_covariates(flag, seq_len, L)
    ctx16 = _context_keys16(base, q, seq_len, flag, L)

    refpos, is_mx, covered = _per_base_refpos_and_mx(pos, op_class, op_len, L)
    gpos = torch.clamp(refoff[:, None] + refpos, 0, ref_classes.shape[0] - 1)
    refc = ref_classes[gpos]
    readc = _lut(_BASE_INT, base)
    err = (is_mx & (readc != refc)).to(torch.int64)

    mask = valid & ~skip & (bidx >= 0) & (q >= MIN_INTERESTING_QUAL)
    max_abs_cycle = torch.where(valid, cycles.abs(), 0).amax() if N * L else (
        torch.zeros((), dtype=torch.int64, device=dev))

    rgq = rg[:, None] * NQUAL + q  # [N, L]
    ncyc = 2 * max_cycle + 1
    qs_size = n_rg * NQUAL
    cyc_size = qs_size * ncyc
    ctx_size = qs_size * NCTX

    qs_idx = torch.where(mask, rgq, qs_size).reshape(-1)
    cyc_idx = torch.where(mask, rgq * ncyc + (cycles + max_cycle),
                          cyc_size).reshape(-1)
    cmask = mask & (ctx16 >= 0)
    ctx_idx = torch.where(cmask, rgq * NCTX + ctx16, ctx_size).reshape(-1)
    return (qs_idx, cyc_idx, ctx_idx, err.reshape(-1), max_abs_cycle,
            qs_size, cyc_size, ctx_size)


def recalibrate_codes(base, qual, seq_len, flag, pos, rg, refoff, skip,
                      op_class, op_len, ref_classes, max_cycle: int, n_rg: int,
                      device=None):
    """Elementwise covariate codes only (flat int64 table indices, the
    0/1 mismatch vector and the largest |cycle|); the caller histograms
    them. Masked elements carry the table's size as their index."""
    dev = _device.resolve(device)
    (qs_idx, cyc_idx, ctx_idx, err, max_abs_cycle,
     _, _, _) = _covariate_codes(base, qual, seq_len, flag, pos, rg, refoff,
                                 skip, op_class, op_len, ref_classes,
                                 max_cycle, n_rg, dev)
    return qs_idx, cyc_idx, ctx_idx, err, max_abs_cycle


def _histogram(idx: torch.Tensor, weight: torch.Tensor, size: int) -> torch.Tensor:
    """Integer counts of ``idx`` in [0, size) weighted by the 0/1
    ``weight``: indices that are negative or past ``size`` land on a
    spare slot at ``size``, which is cut off (the drop semantics of the
    host bincount path)."""
    idx = torch.where((idx < 0) | (idx > size), size, idx)
    out = torch.zeros(size + 1, dtype=torch.int32, device=idx.device)
    out.scatter_add_(0, idx, weight.to(torch.int32))
    return out[:size]


def recalibrate_tables(base, qual, seq_len, flag, pos, rg, refoff, skip,
                       op_class, op_len, ref_classes, max_cycle: int, n_rg: int,
                       device=None):
    """Accumulate the three BQSR tables for one batch of clipped reads.

    Returns (qs_obs, qs_mism, cyc_obs, cyc_mism, ctx_obs, ctx_mism,
    max_abs_cycle) — int32 dense tables (flattened) + the cycle-range
    check value (reference panics when |cycle| > maxCycle, bqsr.go:364-369),
    all tensors on ``device``.
    """
    dev = _device.resolve(device)
    (qs_idx, cyc_idx, ctx_idx, err, max_abs_cycle,
     qs_size, cyc_size, ctx_size) = _covariate_codes(
        base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
        ref_classes, max_cycle, n_rg, dev)
    ones = torch.ones_like(err)
    out = []
    for idx, size in ((qs_idx, qs_size), (cyc_idx, cyc_size), (ctx_idx, ctx_size)):
        out.append(_histogram(idx, ones, size))
        out.append(_histogram(idx, err, size))
    return (*out, max_abs_cycle)


def recalibrate_tables_packed(base_packed, base_lut, qual, seq_len, flag, pos,
                              rg, refoff, skip_packed, op_class, op_len,
                              ref_classes, max_cycle: int, n_rg: int, width: int,
                              device=None):
    """recalibrate_tables over PACKED base/skip columns (ops/packed): the
    4-bit-dictionary base matrix and bit-packed skip mask unpack on
    ``device``, so the dense [n, width] forms never cross the
    host->device link. Equal to recalibrate_tables on the unpacked
    columns."""
    from .packed import unpack_bits, unpack_nibble_dict

    dev = _device.resolve(device)
    base = unpack_nibble_dict(_t(base_packed, dev, torch.uint8),
                              _t(base_lut, dev, torch.uint8), width)
    skip = unpack_bits(_t(skip_packed, dev, torch.uint8), width)
    return recalibrate_tables(
        base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
        ref_classes, max_cycle=max_cycle, n_rg=n_rg, device=dev)


def apply_bqsr(base, qual, seq_len, flag, rg, rg_present, cond_prior, d_cyc,
               d_ctx, quant_lut, sqq_lut, max_cycle: int, device=None):
    """Recalibrate QUAL scores (reference: bqsr.go:936-1006).

    All delta tables are integer-valued (the hierarchical estimate
    condPrior + Δcycle + Δcontext is a sum of integer empirical
    qualities, see filters/bqsr.py), so this is pure int gather+add:

    - cond_prior [nRG, 94] int32 (EQ of the {rg,qual} entry, or the RG
      fallback when absent)
    - d_cyc [nRG, 94, 2*maxCycle+1] int32 (EQ - condPrior, 0 if absent)
    - d_ctx [nRG, 94, 17] int32 (slot 16 = invalid context -> 0)
    - quant_lut [94] uint8, sqq_lut [255] uint8

    Returns (new quals [N, L] uint8, max |cycle|), tensors on ``device``.
    """
    dev = _device.resolve(device)
    base, q = _t(base, dev), _t(qual, dev)
    seq_len, flag, rg = (_t(a, dev) for a in (seq_len, flag, rg))
    rg_present = _t(rg_present, dev, torch.bool)
    cond_prior, d_cyc, d_ctx = (_t(a, dev) for a in (cond_prior, d_cyc, d_ctx))
    quant_lut, sqq_lut = _t(quant_lut, dev), _t(sqq_lut, dev)
    N, L = base.shape
    valid = torch.arange(L, device=dev)[None, :] < seq_len[:, None]

    cycles = _cycle_covariates(flag, seq_len, L)
    max_abs_cycle = torch.where(valid, cycles.abs(), 0).amax() if N * L else (
        torch.zeros((), dtype=torch.int64, device=dev))
    n_rg = cond_prior.shape[0]
    if n_rg == 0:
        # no read group has a table entry: no read is recalibrated
        return q.to(torch.uint8), max_abs_cycle
    ctx16 = _context_keys16(base, q, seq_len, flag, L)
    ctx_idx = torch.where(ctx16 >= 0, ctx16, 16)
    cyc_idx = torch.clamp(cycles + max_cycle, 0, 2 * max_cycle)

    rgc = torch.clamp(rg, 0, n_rg - 1)[:, None]
    qc = torch.clamp(q, 0, NQUAL - 1)
    est = cond_prior[rgc, qc] + d_cyc[rgc, qc, cyc_idx] + d_ctx[rgc, qc, ctx_idx]
    idx = torch.clamp(est, 1, 93)
    newq = sqq_lut[quant_lut[idx]]

    recal_mask = (valid & (q >= MIN_INTERESTING_QUAL) & rg_present[rgc]
                  & (rg >= 0)[:, None])
    out = torch.where(recal_mask, newq, q)
    return out.to(torch.uint8), max_abs_cycle
