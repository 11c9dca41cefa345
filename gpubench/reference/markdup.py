"""Duplicate marking, optical duplicates and the coordinate order, as
elPrep 5.1.3 defines them.

A frozen copy of the repository's sequential oracle (tests/oracle.py:
coordinate_less, unclipped_position, phred_score and
mark_duplicates_oracle, which transliterate sam/sam-types.go:408-473 and
filters/mark-duplicates.go:36-396), moved onto the columns of
``records.Reads``; the optical-duplicate count and the Picard metrics
follow filters/mark-optical-duplicates.go:226-588."""

from __future__ import annotations

import functools
import math
from typing import Dict, List

import numpy as np

from .records import Reads

MULTIPLE, UNMAPPED, NEXT_UNMAPPED = 0x1, 0x4, 0x8
REVERSED, NEXT_REVERSED, FIRST = 0x10, 0x20, 0x40
SECONDARY, DUPLICATE, SUPPLEMENTARY = 0x100, 0x400, 0x800
REF_CONSUMING = {"M": 1, "D": 1, "N": 1, "=": 1, "X": 1}
CLIPPING = {"S": 1, "H": 1}


class Aln:
    __slots__ = ("qname", "flag", "refid", "pos", "mapq", "next_refid", "pnext",
                 "tlen", "libid", "upos", "score", "rg")


def alignments(header: List[str], r: Reads) -> List[Aln]:
    """Per-record view with the derived columns duplicate marking needs."""
    sq = [dict(f.split(":", 1) for f in ln.split("\t")[1:])["SN"]
          for ln in header if ln.startswith("@SQ")]
    refid = {name: i for i, name in enumerate(sq)}
    lib = {}
    for ln in header:
        if ln.startswith("@RG"):
            d = dict(f.split(":", 1) for f in ln.split("\t")[1:])
            lib[d["ID"]] = d.get("LB")
    # phred score: the sum of the base qualities of at least 15
    # (mark-duplicates.go:36-68)
    w = max((len(q) for q in r.qual), default=0)
    q = np.frombuffer(b"".join(x.ljust(w, b"\0") for x in r.qual), np.uint8).reshape(len(r), w)
    scores = np.where(q >= 15, q, 0).sum(axis=1, dtype=np.int64).tolist()
    out = []
    for i in range(len(r)):
        a = Aln()
        a.qname, a.flag, a.pos, a.mapq = r.qname[i], r.flag[i], r.pos[i], r.mapq[i]
        a.refid = refid.get(r.rname[i], -1)
        a.next_refid = refid.get(r.rnext[i], -1)
        a.pnext, a.tlen, a.rg = r.pnext[i], r.tlen[i], r.rg[i]
        a.libid = lib.get(r.rg[i])
        a.upos = unclipped_position(a.pos, a.flag, r.cigar[i])
        a.score = scores[i]
        out.append(a)
    return out


def unclipped_position(pos: int, flag: int, cigar) -> int:
    """(reference: mark-duplicates.go:79-110)"""
    result = pos
    if not cigar:
        return result
    if flag & REVERSED:
        clipped = 1
        result -= 1
        for length, op in reversed(cigar):
            clipped *= CLIPPING.get(op, 0)
            result += (REF_CONSUMING.get(op, 0) | clipped) * length
    else:
        for length, op in cigar:
            if CLIPPING.get(op, 0) == 0:
                break
            result -= length
    return result


def mod_flag(flag: int) -> int:
    if flag & MULTIPLE == 0:
        flag &= ~NEXT_UNMAPPED
        flag &= ~NEXT_REVERSED
    if flag & UNMAPPED:
        flag &= ~REVERSED
    if flag & NEXT_UNMAPPED:
        flag &= ~NEXT_REVERSED
    return flag


def coordinate_less(a: Aln, b: Aln) -> bool:
    """(reference: sam/sam-types.go:425-473)"""
    if a.refid < b.refid:
        return a.refid >= 0
    if b.refid < a.refid:
        return b.refid < 0
    if a.pos != b.pos:
        return a.pos < b.pos
    arev, brev = a.flag & REVERSED != 0, b.flag & REVERSED != 0
    if arev != brev:
        return not arev
    if a.qname != b"" and b.qname != b"":
        if a.qname < b.qname:
            return True
        if a.qname > b.qname:
            return False
    f1, f2 = mod_flag(a.flag), mod_flag(b.flag)
    if f1 != f2:
        return f1 < f2
    if a.mapq != b.mapq:
        return a.mapq < b.mapq
    if (a.flag & MULTIPLE) and (b.flag & MULTIPLE):
        if a.next_refid != b.next_refid:
            return a.next_refid < b.next_refid
        if a.pnext != b.pnext:
            return a.pnext < b.pnext
    return a.tlen < b.tlen


def coordinate_order(alns: List[Aln]) -> List[int]:
    """Record indices in coordinate order (a stable sort)."""
    def cmp(i, j):
        return -1 if coordinate_less(alns[i], alns[j]) else (
            1 if coordinate_less(alns[j], alns[i]) else 0)

    return sorted(range(len(alns)), key=functools.cmp_to_key(cmp))


def _true_fragment(a: Aln) -> bool:
    return (a.flag & (MULTIPLE | NEXT_UNMAPPED)) != MULTIPLE


def _true_pair(a: Aln) -> bool:
    return (a.flag & (MULTIPLE | NEXT_UNMAPPED)) == MULTIPLE


def mark_duplicates(alns: List[Aln]):
    """Sequential emulation of the reference's concurrent marking
    (mark-duplicates.go:210-254, 329-396), in arrival order. Returns the
    duplicate mask and the pair groups {pair key: [(aln1, aln2), ...]}
    in arrival order, winner unmarked."""
    dup = [False] * len(alns)
    fragments: Dict = {}
    pending: Dict = {}
    pairs: Dict = {}
    groups: Dict = {}
    for i, r in enumerate(alns):
        if r.flag & (UNMAPPED | SECONDARY | SUPPLEMENTARY):
            continue
        key = (r.libid, r.refid, r.upos, (r.flag & REVERSED) != 0)
        if key not in fragments:
            fragments[key] = i
        else:
            best = fragments[key]
            if _true_fragment(r):
                if _true_pair(alns[best]):
                    dup[i] = True
                elif alns[best].score > r.score:
                    dup[i] = True
                elif alns[best].score == r.score:
                    if r.qname > alns[best].qname:
                        dup[i] = True
                    else:
                        dup[best] = True
                        fragments[key] = i
                else:
                    dup[best] = True
                    fragments[key] = i
            elif not _true_pair(alns[best]):
                dup[best] = True
                fragments[key] = i

        if not _true_pair(r):
            continue
        pkey = (r.libid, r.qname)
        if pkey not in pending:
            pending[pkey] = i
            continue
        a1, a2 = i, pending.pop(pkey)
        score = alns[a1].score + alns[a2].score
        x, y = alns[a1], alns[a2]
        if x.refid > y.refid or (x.refid == y.refid and (
                x.upos > y.upos or (x.upos == y.upos and (x.flag & REVERSED)
                                    and not (y.flag & REVERSED)))):
            a1, a2 = a2, a1
            x, y = y, x
        key2 = (x.libid, x.refid, y.refid, x.upos, y.upos,
                (x.flag & REVERSED) != 0, (y.flag & REVERSED) != 0)
        groups.setdefault(key2, []).append((a1, a2))
        if key2 not in pairs:
            pairs[key2] = (score, a1, a2)
            continue
        bscore, b1, b2 = pairs[key2]
        if bscore > score:
            dup[a1] = dup[a2] = True
        elif bscore == score:
            if alns[a1].qname > alns[b1].qname:
                dup[a1] = dup[a2] = True
            else:
                dup[b1] = dup[b2] = True
                pairs[key2] = (score, a1, a2)
        else:
            dup[b1] = dup[b2] = True
            pairs[key2] = (score, a1, a2)
    return dup, groups


def _tile(qname: bytes):
    """(tile, x, y) of a 5- or 7-field Illumina name
    (mark-optical-duplicates.go:50-71)."""
    f = qname.split(b":")
    try:
        if len(f) == 7:
            return int(f[4]), int(f[5]), int(f[6])
        if len(f) == 5:
            return int(f[2]), int(f[3]), int(f[4])
    except ValueError:
        pass
    return None


def _optical_in(reads: List[Aln], dist: int) -> int:
    """Size less the number of clusters of reads on one read group and
    tile within ``dist`` pixels in x and in y (the reference's graph
    clustering, mark-optical-duplicates.go:226-273)."""
    parent = list(range(len(reads)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    tiles = [_tile(a.qname) for a in reads]
    for i in range(len(reads)):
        for j in range(i + 1, len(reads)):
            ti, tj = tiles[i], tiles[j]
            if (ti is not None and tj is not None and reads[i].rg == reads[j].rg
                    and ti[0] == tj[0] and abs(ti[1] - tj[1]) <= dist
                    and abs(ti[2] - tj[2]) <= dist):
                a, b = find(i), find(j)
                if a != b:
                    parent[a] = b
    return len(reads) - len({find(i) for i in range(len(reads))})


def _library_size(n_pairs: int, n_unique: int) -> int:
    """Picard's estimateLibrarySize bisection (mark-optical-duplicates.go:541-569)."""
    def f(x, c, n):
        return c / x - 1 + math.exp(-n / x)

    c, n = float(n_unique), float(n_pairs)
    if n_pairs <= 0 or n_pairs - n_unique <= 0:
        return 0
    m, big = 1.0, 100.0
    while f(big * c, c, n) >= 0.0:
        big *= 10.0
    for _ in range(40):
        r = (m + big) / 2.0
        u = f(r * c, c, n)
        if u == 0.0:
            break
        if u > 0.0:
            m = r
        if u < 0.0:
            big = r
    return int(c * ((m + big) / 2.0))


def duplication_metrics(alns: List[Aln], dup: List[bool], groups, dist: int = 100):
    """{library: counts} of the Picard DuplicationMetrics line."""
    out: Dict[str, Dict[str, float]] = {}

    def ctr(lib):
        return out.setdefault(lib or "Unknown Library", dict.fromkeys((
            "UNPAIRED_READS_EXAMINED", "READ_PAIRS_EXAMINED", "SECONDARY_OR_SUPPLEMENTARY_RDS",
            "UNMAPPED_READS", "UNPAIRED_READ_DUPLICATES", "READ_PAIR_DUPLICATES",
            "READ_PAIR_OPTICAL_DUPLICATES"), 0))

    for i, a in enumerate(alns):
        c = ctr(a.libid)
        if a.flag & UNMAPPED:
            c["UNMAPPED_READS"] += 1
        elif a.flag & (SECONDARY | SUPPLEMENTARY):
            c["SECONDARY_OR_SUPPLEMENTARY_RDS"] += 1
        elif _true_pair(a):
            c["READ_PAIRS_EXAMINED"] += 1
            if dup[i] and a.flag & FIRST:
                c["READ_PAIR_DUPLICATES"] += 1
        else:
            c["UNPAIRED_READS_EXAMINED"] += 1
            c["UNPAIRED_READ_DUPLICATES"] += dup[i]
    for c in out.values():
        c["READ_PAIRS_EXAMINED"] //= 2
    for members in groups.values():
        if len(members) < 2:
            continue
        reps = [a1 if alns[a1].flag & FIRST else a2 for a1, a2 in members]
        for strand in (0, REVERSED):
            same = [alns[r] for r in reps if alns[r].flag & REVERSED == strand]
            if len(same) > 1:
                ctr(alns[reps[0]].libid)["READ_PAIR_OPTICAL_DUPLICATES"] += _optical_in(same, dist)
    for c in out.values():
        pairs, unpaired = c["READ_PAIRS_EXAMINED"], c["UNPAIRED_READS_EXAMINED"]
        denom = unpaired + 2 * pairs
        c["PERCENT_DUPLICATION"] = ((c["UNPAIRED_READ_DUPLICATES"] + 2 * c["READ_PAIR_DUPLICATES"])
                                    / denom if denom else float("nan"))
        if pairs > 0:
            c["ESTIMATED_LIBRARY_SIZE"] = _library_size(
                pairs - c["READ_PAIR_OPTICAL_DUPLICATES"], pairs - c["READ_PAIR_DUPLICATES"])
    return out
