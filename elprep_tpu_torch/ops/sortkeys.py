"""Device-side sorting: multi-key stable sort replicating elPrep's
alignment comparators.

elPrep sorts ``[]*Alignment`` with a parallel stable merge sort over the
``CoordinateLess`` predicate (reference: sam/sam-types.go:425-473,
599-641). Here the comparator becomes int64 key columns whose
lexicographic order is exactly ``CoordinateLess`` order, sorted with
stable ``torch.sort`` passes (least-significant key first) on the
caller's device.

Key construction notes:

- invalid refids (-1) sort *after* all valid ones
  (sam-types.go:428-432: ``refid1 < refid2 -> refid1 >= 0``);
- QNAME comparison is lexicographic on bytes; we pre-compute an ordinal
  rank per unique QNAME on the host and compare ranks;
- ``modFlag`` masks NextUnmapped/NextReversed/Reversed bits conditioned
  on Multiple/Unmapped/NextUnmapped (sam-types.go:408-420);
- the mate keys (NextREFID, PNEXT) only apply when *both* reads have the
  Multiple flag (sam-types.go:458-470); since they are compared only
  after FLAG compares equal — and modFlag preserves the Multiple bit —
  "both multiple" is equivalent to "this read is multiple", so a
  per-element key ``multiple ? mate_key : 0`` is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device

INT32_MAX = np.int32(2**31 - 1)

MULTIPLE = 0x1
UNMAPPED = 0x4
NEXT_UNMAPPED = 0x8
REVERSED = 0x10
NEXT_REVERSED = 0x20


def _as_i64(a, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=dev, dtype=torch.int64)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One signed int64 whose order is the lexicographic order of two
    int32 keys: the high word keeps its sign and only the low word is
    biased into [0, 2^32), so no value wraps past 2^63."""
    return hi * (1 << 32) + (lo + (1 << 31))


def coordinate_keys(flag, refid, pos, mapq, next_refid, pnext, tlen, qrank):
    """Key columns (int64 tensors) whose lexicographic order equals
    CoordinateLess (reference: sam/sam-types.go:425-473)."""
    f = flag
    mf = torch.where((f & MULTIPLE) == 0, f & ~(NEXT_UNMAPPED | NEXT_REVERSED), f)
    mf = torch.where((mf & UNMAPPED) != 0, mf & ~REVERSED, mf)
    mf = torch.where((mf & NEXT_UNMAPPED) != 0, mf & ~NEXT_REVERSED, mf)
    k_refid = torch.where(refid >= 0, refid, torch.full_like(refid, int(INT32_MAX)))
    k_rev = (f >> 4) & 1
    multiple = (f & MULTIPLE) != 0
    zero = torch.zeros_like(f)
    k_nrefid = torch.where(multiple, next_refid, zero)
    k_pnext = torch.where(multiple, pnext, zero)
    return (k_refid, pos, k_rev, qrank, mf, mapq, k_nrefid, k_pnext, tlen)


def coordinate_sort_perm(flag, refid, pos, mapq, next_refid, pnext, tlen, qrank,
                         device=None) -> torch.Tensor:
    """Stable coordinate-sort permutation (int64 tensor on ``device``).

    Five stable sorts, least-significant first; adjacent comparator keys
    pair up into one int64 each (``_pair_key``), and modFlag < 2^16 /
    mapq < 2^8 pack bit-exactly into one word, as in the JAX package's
    five int32 passes."""
    dev = _device.resolve(device)
    cols = [_as_i64(a, dev) for a in (flag, refid, pos, mapq, next_refid,
                                       pnext, tlen, qrank)]
    (k_refid, k_pos, k_rev, k_qrank, k_mf, k_mapq, k_nrefid, k_pnext,
     k_tlen) = coordinate_keys(*cols)
    words = (
        _pair_key(k_refid, k_pos),
        _pair_key(k_rev, k_qrank),
        (k_mf << 8) | k_mapq,
        _pair_key(k_nrefid, k_pnext),
        k_tlen,
    )
    perm = torch.arange(k_pos.shape[0], device=dev)
    for w in reversed(words):
        order = torch.sort(w[perm], stable=True).indices
        perm = perm[order]
    return perm


def coordinate_keys_np(flag, refid, pos, mapq, next_refid, pnext, tlen, qrank):
    """numpy twin of coordinate_keys (bit-identical key columns)."""
    f = np.asarray(flag)
    not_mult = (f & MULTIPLE) == 0
    mf = np.where(not_mult, f & ~(NEXT_UNMAPPED | NEXT_REVERSED), f)
    mf = np.where((mf & UNMAPPED) != 0, mf & ~REVERSED, mf)
    mf = np.where((mf & NEXT_UNMAPPED) != 0, mf & ~NEXT_REVERSED, mf)
    k_refid = np.where(refid >= 0, refid, INT32_MAX)
    k_rev = (f >> 4) & 1
    multiple = (f & MULTIPLE) != 0
    k_nrefid = np.where(multiple, next_refid, 0)
    k_pnext = np.where(multiple, pnext, 0)
    return (k_refid, np.asarray(pos), k_rev, np.asarray(qrank), mf,
            np.asarray(mapq), k_nrefid, k_pnext, np.asarray(tlen))


def coordinate_sort_perm_host(flag, refid, pos, mapq, next_refid, pnext,
                              tlen, qrank) -> np.ndarray:
    """Host twin of coordinate_sort_perm: one stable sort over the same
    key columns yields the identical permutation. Fast path: the nine
    keys pack order-preservingly into four words for ONE native stable
    sort (np.lexsort is the fallback/oracle)."""
    keys = coordinate_keys_np(flag, refid, pos, mapq, next_refid, pnext,
                              tlen, qrank)
    (k_refid, k_pos, k_rev, k_qrank, k_mf, k_mapq, k_nrefid, k_pnext,
     k_tlen) = keys
    from .. import native

    u64 = np.uint64
    bias = np.int64(1) << 31
    # non-overlapping, order-preserving bit fields:
    #   w0 = refid(31) . pos(31)          both non-negative < 2^31
    #   w1 = rev(1) . qrank(31) . modFlag(16) . mapq(8)
    #   w2 = nrefid+2^31(32) . pnext(31)  pnext >= 0
    #   w3 = tlen+2^31(32)                signed -> biased
    w0 = (k_refid.astype(u64) << u64(32)) | k_pos.astype(u64)
    w1 = ((k_rev.astype(u64) << u64(55))
          | (k_qrank.astype(u64) << u64(24))
          | (k_mf.astype(u64) << u64(8)) | k_mapq.astype(u64))
    w2 = (((k_nrefid.astype(np.int64) + bias).astype(u64) << u64(32))
          | k_pnext.astype(u64))
    w3 = (k_tlen.astype(np.int64) + bias).astype(np.uint64)
    perm = native.stable_sort_idx(w0, w1, w2, w3)
    if perm is not None:
        return perm
    return np.lexsort(tuple(reversed(keys))).astype(np.int32)


def queryname_sort_perm(qrank, device=None) -> torch.Tensor:
    """Stable queryname-sort permutation (reference: sam/sam-types.go:479-481)."""
    dev = _device.resolve(device)
    return torch.sort(_as_i64(qrank, dev), stable=True).indices


def qname_ranks(qnames: np.ndarray) -> np.ndarray:
    """Host-side ordinal ranks of QNAMEs under bytewise lexicographic order
    (Go string compare == numpy 'S' compare for ASCII). The native
    parallel sort is the fast path; the numpy branch is its oracle."""
    import os

    if not os.environ.get("ELPREP_TPU_NO_NATIVE_QRANK"):
        from .. import native

        got = native.qname_ranks_fixed(qnames)
        if got is not None:
            return got
    _, inverse = np.unique(qnames, return_inverse=True)
    return inverse.astype(np.int32)


def qname_ranks_cached(batch) -> np.ndarray:
    """qname_ranks memoized in a per-batch cache temp: dedup and the
    coordinate sort both need the ranks of the same batch. The cache
    survives select()'s row gather (a subset preserves relative rank
    order, which is all either consumer compares) and is excluded from
    ReadBatch.concat (ranks are batch-relative)."""
    r = batch.temps.get("_QRANK")
    if r is None:
        r = qname_ranks(batch.qname)
        batch.temps["_QRANK"] = r
    return r
