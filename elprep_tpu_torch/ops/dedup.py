"""Sort-based duplicate marking, as torch ops on the caller's device.

elPrep's signature algorithm marks duplicates in a single concurrent pass
using lock-free CAS hash maps (reference: filters/mark-duplicates.go:
classifyFragment :210-254, classifyPair :329-396). The *outcome* of those
CAS duels is deterministic; we reproduce it with a sort-based
formulation: sort by the dedup key, then segmented reductions.

Semantics reproduced exactly:

- only reads with none of Unmapped|Secondary|Supplementary participate
  (mark-duplicates.go:427,436);
- a read is a "true pair" iff (FLAG & (Multiple|NextUnmapped)) == Multiple
  (mark-duplicates.go:177-184);
- FRAGMENT phase, key {LIBID, REFID, unclipped-pos, reversed}
  (mark-duplicates.go:188-216): if the group contains any true pair, all
  true fragments are duplicates; otherwise every true fragment except the
  winner is a duplicate. Winner = highest score, then lexicographically
  smallest QNAME, then latest arrival (the CAS loop lets the last equal
  contender replace the incumbent, mark-duplicates.go:231-238);
- PAIR phase: true pairs are joined by {LIBID, QNAME} in arrival order
  (DeleteOrStore, mark-duplicates.go:336-340), canonically ordered by
  (refid, pos, reversed) (mark-duplicates.go:343-353), then grouped by
  {LIBID, refid1, refid2, pos1, pos2, rev1, rev2}; every losing pair has
  *both* reads marked. Winner = highest score sum, then smallest QNAME,
  then latest arrival (mark-duplicates.go:375-395).

The returned ``dup_mask`` is OR-ed into FLAG bit 0x400 by the caller.
On ``cuda`` the whole computation stays on the card (three sorts of
packed int64 keys + segment reductions); on the CPU the numpy/native
twin :func:`mark_duplicates_host` runs, which gives the same mask.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device

INT32_MAX = np.int32(2**31 - 1)
INT32_MIN = np.int32(-(2**31))

MULTIPLE = 0x1
NEXT_UNMAPPED = 0x8
REVERSED = 0x10
ELIGIBLE_EXCLUDE = 0x4 | 0x100 | 0x800  # Unmapped|Secondary|Supplementary


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One signed int64 whose order is the lexicographic order of two
    int32 keys: the high word keeps its sign and only the low word is
    biased into [0, 2^32), so negative keys (libid -1, refid -1) order
    correctly and nothing wraps past 2^63."""
    return hi * (1 << 32) + (lo + (1 << 31))


def _lexsort_perm(*keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort, primary key first: adjacent int32
    keys pack into one int64 word each, then one stable sort per word,
    least-significant first. Ties keep the arrival (row) order."""
    words = [_pair_key(keys[i], keys[i + 1]) if i + 1 < len(keys) else keys[i]
             for i in range(0, len(keys), 2)]
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def _segment_ids(*key_cols: torch.Tensor) -> torch.Tensor:
    """Segment ids for sorted key columns: increments where any key changes."""
    change = torch.zeros_like(key_cols[0], dtype=torch.bool)
    for k in key_cols:
        change |= k != torch.roll(k, 1)
    change[:1].fill_(True)  # fill_, not a copy of a host scalar: capturable
    return torch.cumsum(change.to(torch.int64), 0) - 1


def _seg_reduce(x: torch.Tensor, seg: torch.Tensor, how: str) -> torch.Tensor:
    """Per-element segment max/min (``how`` = amax|amin), gathered back."""
    out = torch.zeros_like(x).scatter_reduce(0, seg, x, how, include_self=False)
    return out[seg]


def mark_duplicates(libid, refid, upos, rev, score, qrank, flag,
                    device=None) -> torch.Tensor:
    """Compute the duplicate mask for one batch on ``device``.

    All args int32-valued [N] (numpy arrays or tensors); ``rev`` is 0/1;
    ``score`` is the adapted Phred score; ``qrank`` is the QNAME ordinal
    rank; arrival order is the array index. Returns a bool [N] tensor.
    """
    dev = _device.resolve(device)
    libid, refid, upos, rev, score, qrank, flag = (
        torch.as_tensor(a).to(device=dev, dtype=torch.int64)
        for a in (libid, refid, upos, rev, score, qrank, flag))
    n = flag.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    idx = torch.arange(n, device=dev)

    eligible = (flag & ELIGIBLE_EXCLUDE) == 0
    true_pair = eligible & ((flag & (MULTIPLE | NEXT_UNMAPPED)) == MULTIPLE)
    true_frag = eligible & ~true_pair
    # made on the device (torch.tensor would copy from the host: not
    # capturable into a CUDA graph)
    i32_min = torch.full((), int(INT32_MIN), dtype=torch.int64, device=dev)
    i32_max = torch.full((), int(INT32_MAX), dtype=torch.int64, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    # FRAGMENT phase
    # ------------------------------------------------------------------
    inel = (~eligible).to(torch.int64)
    fperm = _lexsort_perm(inel, libid, refid, upos, rev)
    s_inel, s_lib, s_ref, s_upos, s_rev = (
        inel[fperm], libid[fperm], refid[fperm], upos[fperm], rev[fperm])
    s_pair = true_pair.to(torch.int64)[fperm]
    s_frag = true_frag[fperm]
    s_score, s_qrank, s_idx = score[fperm], qrank[fperm], idx[fperm]
    seg = _segment_ids(s_inel, s_lib, s_ref, s_upos, s_rev)

    has_pair = _seg_reduce(s_pair, seg, "amax") > 0
    frag_score = torch.where(s_frag, s_score, i32_min)
    best_score = _seg_reduce(frag_score, seg, "amax")
    tie = s_frag & (s_score == best_score)
    best_qrank = _seg_reduce(torch.where(tie, s_qrank, i32_max), seg, "amin")
    tie2 = tie & (s_qrank == best_qrank)
    winner_idx = _seg_reduce(torch.where(tie2, s_idx, minus1), seg, "amax")
    frag_winner = tie2 & (s_idx == winner_idx) & ~has_pair
    frag_dup = s_frag & (s_inel == 0) & ~frag_winner
    # one extra slot at index n takes the pair losers' dropped writes below
    dup = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    dup[s_idx] = frag_dup  # s_idx is a permutation: every row written once

    # ------------------------------------------------------------------
    # PAIR formation: join true pairs by {LIBID, QNAME} in arrival order
    # ------------------------------------------------------------------
    not_cand = (~true_pair).to(torch.int64)
    pperm = _lexsort_perm(not_cand, libid, qrank, idx)
    p_nc, p_lib, p_qrank, p_idx = (
        not_cand[pperm], libid[pperm], qrank[pperm], idx[pperm])
    p_ref, p_upos, p_rev, p_score = (
        refid[pperm], upos[pperm], rev[pperm], score[pperm])
    pseg = _segment_ids(p_nc, p_lib, p_qrank)
    pos_in_run = idx - _seg_reduce(idx, pseg, "amin")
    # read at odd position pairs with its predecessor (DeleteOrStore order)
    is_second = (p_nc == 0) & (pos_in_run % 2 == 1)

    # partner (previous sorted position) fields; row 0 wraps to the last
    # row, but is never a second (its position in its run is 0)
    a_ref, a_upos, a_rev, a_score, a_idx = p_ref, p_upos, p_rev, p_score, p_idx
    b_ref, b_upos, b_rev, b_score, b_idx = (
        torch.roll(x, 1) for x in (p_ref, p_upos, p_rev, p_score, p_idx))

    # canonical ordering (mark-duplicates.go:343-353): here aln1 = the later
    # arrival (a), aln2 = the earlier (b); swap if out of canonical order.
    swap = (a_ref > b_ref) | (
        (a_ref == b_ref)
        & ((a_upos > b_upos) | ((a_upos == b_upos) & (a_rev == 1) & (b_rev == 0)))
    )
    r1 = torch.where(swap, b_ref, a_ref)
    r2 = torch.where(swap, a_ref, b_ref)
    po1 = torch.where(swap, b_upos, a_upos)
    po2 = torch.where(swap, a_upos, b_upos)
    rv1 = torch.where(swap, b_rev, a_rev)
    rv2 = torch.where(swap, a_rev, b_rev)
    pscore = a_score + b_score
    parrival = torch.maximum(a_idx, b_idx)

    # ------------------------------------------------------------------
    # PAIR dedup: group by {LIBID, r1, r2, po1, po2, rv1, rv2}
    # ------------------------------------------------------------------
    invalid = (~is_second).to(torch.int64)
    gperm = _lexsort_perm(invalid, p_lib, r1, r2, po1, po2, rv1, rv2)
    g_keys = tuple(k[gperm] for k in (invalid, p_lib, r1, r2, po1, po2, rv1, rv2))
    g_score, g_q, g_arr = pscore[gperm], p_qrank[gperm], parrival[gperm]
    g_ia, g_ib = a_idx[gperm], b_idx[gperm]
    gseg = _segment_ids(*g_keys)

    valid = g_keys[0] == 0
    gbest_score = _seg_reduce(torch.where(valid, g_score, i32_min), gseg, "amax")
    gtie = valid & (g_score == gbest_score)
    gbest_q = _seg_reduce(torch.where(gtie, g_q, i32_max), gseg, "amin")
    gtie2 = gtie & (g_q == gbest_q)
    gbest_arr = _seg_reduce(torch.where(gtie2, g_arr, minus1), gseg, "amax")
    gwinner = gtie2 & (g_arr == gbest_arr)
    gloser = valid & ~gwinner

    # both reads of a losing pair; every other row writes the spare slot n
    # (torch has no dropping scatter: an index of n would be out of range)
    sink = torch.full_like(g_ia, n)
    dup.index_fill_(0, torch.where(gloser, g_ia, sink), True)
    dup.index_fill_(0, torch.where(gloser, g_ib, sink), True)
    return dup[:n]


def mark_duplicates_host(libid, refid, upos, rev, score, qrank, flag
                         ) -> np.ndarray:
    """numpy twin of :func:`mark_duplicates` (identical mask: the same
    stable sorts and integer duels, via np.lexsort + reduceat). The CPU
    route's engine."""
    libid, refid, upos, rev, score, qrank, flag = (
        np.asarray(a) for a in (libid, refid, upos, rev, score, qrank, flag))
    n = flag.shape[0]
    idx = np.arange(n, dtype=np.int32)

    from .. import native

    _bias = np.int64(1) << 31

    def _b32(a):
        """int32-ish column biased into an unsigned 32-bit field."""
        return (np.asarray(a).astype(np.int64) + _bias).astype(np.uint64)

    def _lexsort(keys):
        """Stable lexicographic argsort, primary key FIRST. Packs the
        int32 key columns order-preservingly into biased 32-bit fields
        of up to four words for one native stable sort; np.lexsort is
        the fallback (and the oracle the packing must match)."""
        words = []
        cur, used = None, 0
        for k in keys:
            f = _b32(k)
            if used == 0:
                cur, used = f, 1
            else:
                cur = (cur << np.uint64(32)) | f
                words.append(cur)
                cur, used = None, 0
        if used:
            words.append(cur)
        if len(words) <= 4:
            w = words + [None] * (4 - len(words))
            perm = native.stable_sort_idx(w[0], w[1], w[2], w[3])
            if perm is not None:
                return perm
        return np.lexsort(tuple(reversed(keys)))

    eligible = (flag & ELIGIBLE_EXCLUDE) == 0
    true_pair = eligible & ((flag & (MULTIPLE | NEXT_UNMAPPED)) == MULTIPLE)
    true_frag = eligible & ~true_pair

    dup = np.zeros(n, dtype=bool)
    if n == 0:
        return dup

    def seg_ids(*cols):
        change = np.zeros(n, dtype=bool)
        for k in cols:
            change |= k != np.roll(k, 1)
        change[0] = True
        starts = np.flatnonzero(change)
        return np.cumsum(change) - 1, starts

    # FRAGMENT phase
    inel = (~eligible).astype(np.int32)
    fperm = _lexsort((inel, libid, refid, upos, rev))
    s_inel, s_upos = inel[fperm], upos[fperm]
    s_lib, s_ref, s_rev = libid[fperm], refid[fperm], rev[fperm]
    s_pair = true_pair[fperm]
    s_frag = true_frag[fperm]
    s_score, s_qrank, s_idx = score[fperm], qrank[fperm], idx[fperm]
    seg, starts = seg_ids(s_inel, s_lib, s_ref, s_upos, s_rev)

    has_pair = np.maximum.reduceat(s_pair, starts)[seg]
    frag_score = np.where(s_frag, s_score, INT32_MIN)
    best_score = np.maximum.reduceat(frag_score, starts)[seg]
    tie = s_frag & (s_score == best_score)
    tie_qrank = np.where(tie, s_qrank, INT32_MAX)
    best_qrank = np.minimum.reduceat(tie_qrank, starts)[seg]
    tie2 = tie & (s_qrank == best_qrank)
    tie_idx = np.where(tie2, s_idx, -1)
    winner_idx = np.maximum.reduceat(tie_idx, starts)[seg]
    frag_winner = tie2 & (s_idx == winner_idx) & ~has_pair
    frag_dup = s_frag & (s_inel == 0) & ~frag_winner
    dup[s_idx[frag_dup]] = True

    # PAIR formation by {LIBID, QNAME} in arrival order
    not_cand = (~true_pair).astype(np.int32)
    pperm = _lexsort((not_cand, libid, qrank, idx))
    p_nc, p_lib, p_qrank, p_idx = (
        not_cand[pperm], libid[pperm], qrank[pperm], idx[pperm])
    p_ref, p_upos, p_rev, p_score = (
        refid[pperm], upos[pperm], rev[pperm], score[pperm])
    pseg, pstarts = seg_ids(p_nc, p_lib, p_qrank)
    ar = np.arange(n, dtype=np.int32)
    pos_in_run = ar - pstarts[pseg]
    is_second = (p_nc == 0) & (pos_in_run % 2 == 1)

    a_ref, a_upos, a_rev, a_score, a_idx = p_ref, p_upos, p_rev, p_score, p_idx
    b_ref, b_upos, b_rev, b_score, b_idx = (
        np.roll(p_ref, 1), np.roll(p_upos, 1), np.roll(p_rev, 1),
        np.roll(p_score, 1), np.roll(p_idx, 1))

    swap = (a_ref > b_ref) | (
        (a_ref == b_ref)
        & ((a_upos > b_upos) | ((a_upos == b_upos) & (a_rev == 1) & (b_rev == 0)))
    )
    r1 = np.where(swap, b_ref, a_ref)
    r2 = np.where(swap, a_ref, b_ref)
    po1 = np.where(swap, b_upos, a_upos)
    po2 = np.where(swap, a_upos, b_upos)
    rv1 = np.where(swap, b_rev, a_rev)
    rv2 = np.where(swap, a_rev, b_rev)
    pscore = a_score + b_score
    parrival = np.maximum(a_idx, b_idx)
    pq = p_qrank

    # PAIR dedup by {LIBID, r1, r2, po1, po2, rv1, rv2}
    invalid = (~is_second).astype(np.int32)
    gperm = _lexsort((invalid, p_lib, r1, r2, po1, po2, rv1, rv2))
    (g_inv, g_lib, g_r1, g_r2, g_p1, g_p2, g_v1, g_v2) = (
        invalid[gperm], p_lib[gperm], r1[gperm], r2[gperm], po1[gperm],
        po2[gperm], rv1[gperm], rv2[gperm])
    g_score, g_q, g_arr = pscore[gperm], pq[gperm], parrival[gperm]
    g_ia, g_ib = a_idx[gperm], b_idx[gperm]
    gseg, gstarts = seg_ids(g_inv, g_lib, g_r1, g_r2, g_p1, g_p2, g_v1, g_v2)

    valid = g_inv == 0
    vscore = np.where(valid, g_score, INT32_MIN)
    gbest_score = np.maximum.reduceat(vscore, gstarts)[gseg]
    gtie = valid & (g_score == gbest_score)
    gq = np.where(gtie, g_q, INT32_MAX)
    gbest_q = np.minimum.reduceat(gq, gstarts)[gseg]
    gtie2 = gtie & (g_q == gbest_q)
    garr = np.where(gtie2, g_arr, -1)
    gbest_arr = np.maximum.reduceat(garr, gstarts)[gseg]
    gwinner = gtie2 & (g_arr == gbest_arr)
    gloser = valid & ~gwinner

    dup[g_ia[gloser]] = True
    dup[g_ib[gloser]] = True
    return dup


def dedup_columns(batch, header, device=None):
    """Host-derived dedup input columns: (libid, unclipped-pos, score,
    rev) int32 arrays for a ReadBatch.

    LIBID mapping: @RG ID -> LB (reference: mark-duplicates.go:411-423);
    libids are assigned canonically in @RG header order (optical.py
    rebuilds the same table from the header). On the CPU the one-pass
    native engine derives score and position; on ``cuda`` (or without
    the native library) the padded readstats ops on ``device`` do."""
    from . import readstats

    lb_by_rg = {}
    for rg_entry in header.rg:
        lb = rg_entry.get("LB")
        if lb is not None:
            rg_id = rg_entry.get("ID")
            if rg_id is None:
                raise ValueError("Missing mandatory ID entry in an @RG line in a SAM file header.")
            lb_by_rg[rg_id.encode()] = lb

    rg_vals = batch.tags.extract_z(b"RG")
    lb_ids: dict[str, int] = {}
    for rg_entry in header.rg:
        lb = rg_entry.get("LB")
        if lb is not None and lb not in lb_ids:
            lb_ids[lb] = len(lb_ids)
    # every mappable LB is pre-seeded from the header above, so the
    # per-read assignment reduces to a unique-RG lookup table
    uq, inv = np.unique(rg_vals, return_inverse=True)
    lut = np.fromiter(
        (lb_ids.get(lb_by_rg.get(rg), -1) for rg in uq),
        np.int32, len(uq))
    libid = lut[inv].astype(np.int32)

    from .dispatch import routes_to_host

    got = None
    if routes_to_host(len(batch), device):
        # one-pass ragged native twin: no padded [n,L]/[n,C] cigar and
        # qual matrices (the readstats ops below are its oracle)
        from .. import native

        got = native.dedup_score_upos(
            batch.qual.data, batch.qual.offsets, batch.cigar_len.data,
            batch.cigar_op.data, batch.cigar_op.offsets, batch.pos,
            batch.flag)
    if got is not None:
        upos, score = got
    else:
        op_class, op_len, n_ops = readstats.pad_cigars(batch.cigar_len, batch.cigar_op)
        qual_padded, qual_len = readstats.pad_quals(batch.qual)
        upos = readstats.unclipped_position(
            batch.pos, batch.flag, op_class, op_len, n_ops, device=device
        ).cpu().numpy()
        score = readstats.phred_score(qual_padded, qual_len, device=device).cpu().numpy()
    rev = ((batch.flag & REVERSED) >> 4).astype(np.int32)
    return libid, upos, score, rev


def mark_duplicates_batch(batch, header, device=None):
    """Host glue: derive dedup input columns from a ReadBatch + header and
    compute the mask on ``device`` (``None``: the session default).
    Returns (dup_mask, aux dict with the derived columns for reuse by
    optical-duplicate marking).

    LIBID mapping: @RG ID -> LB (reference: mark-duplicates.go:411-423);
    reads without an RG tag or whose RG has no LB get LIBID nil, which is
    its own group key value (-1 here).
    """
    from . import sortkeys
    from .dispatch import routes_to_host

    libid, upos, score, rev = dedup_columns(batch, header, device)
    refid = batch.temps["REFID"]
    qrank = sortkeys.qname_ranks_cached(batch)

    if routes_to_host(len(batch), device):
        dup = mark_duplicates_host(libid, refid, upos, rev, score, qrank,
                                   batch.flag)
    else:
        dup = mark_duplicates(libid, refid, upos, rev, score, qrank,
                              batch.flag, device=device).cpu().numpy()
    aux = {"libid": libid, "upos": upos, "score": score, "qrank": qrank}
    return dup, aux
