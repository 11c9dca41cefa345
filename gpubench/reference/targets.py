"""Capture targets, as elPrep 5.1.3 uses a ``--target-regions`` BED:
the reads that ``RemoveNonOverlappingReads`` keeps
(filters/simple-filters.go:310-328) and the calling spans, one per
flattened interval, that the HaplotypeCaller's ``computeRegion``s
cover (filters/haplotypecaller.go:735-798).

A BED interval is 0-based and half-open: ``start end`` holds the
1-based positions start + 1 to end. Intervals of a contig are sorted by
start and flattened: one that starts at or before the end of the one
before it (touching included) extends it (intervals/intervals.go:88-141)."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from .records import Reads

REF_OPS = "MDN=X"    # operations that consume reference bases
READ_OPS = "MIS=X"   # operations that consume read bases


def read_bed(path: str) -> Dict[str, List[Tuple[int, int]]]:
    """{contig: flattened [(start, end)]} of a BED file; header, track
    and browser lines skipped."""
    raw: Dict[str, List[Tuple[int, int]]] = {}
    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if not ln or ln.startswith(("#", "track", "browser")):
                continue
            f = ln.split("\t")
            raw.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    out = {}
    for c, ivals in raw.items():
        merged: List[List[int]] = []
        for s, e in sorted(ivals, key=lambda iv: iv[0]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out[c] = [(s, e) for s, e in merged]
    return out


def spans(bed: Dict[str, List[Tuple[int, int]]]) -> Dict[str, List[Tuple[int, int]]]:
    """The calling spans: each flattened interval as 1-based first and
    last position."""
    return {c: [(s + 1, e) for s, e in ivals] for c, ivals in bed.items()}


def kept(r: Reads, bed: Dict[str, List[Tuple[int, int]]]) -> List[bool]:
    """Whether each read overlaps an interval: its alignment, from POS
    over its reference length, shares a position with one. An unmapped
    read, or one with no read length by its CIGAR, counts at POS alone."""
    starts = {c: [s for s, _ in ivals] for c, ivals in bed.items()}
    out = []
    for i in range(len(r)):
        ivals = bed.get(r.rname[i])
        if not ivals:
            out.append(False)
            continue
        cig = r.cigar[i]
        ref_len = sum(n for n, op in cig if op in REF_OPS)
        read_len = sum(n for n, op in cig if op in READ_OPS)
        first = r.pos[i]
        last = first + ref_len - 1 if not r.flag[i] & 0x4 and read_len > 0 else first
        # the last interval that starts at or before ``last`` (1-based
        # start + 1 <= last) is the only one that can reach ``first``
        k = bisect.bisect_left(starts[r.rname[i]], last) - 1
        out.append(k >= 0 and ivals[k][1] >= first)
    return out
