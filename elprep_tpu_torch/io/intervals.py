"""Genomic intervals and the .elsites format
(reference: intervals/intervals.go).

Intervals are numpy structured as two int32 arrays (start, end) per
chromosome; flatten/overlap/intersect use vectorized numpy instead of the
reference's parallel divide-and-conquer, with identical results:

- ``flatten`` merges intervals where next.start <= current.end
  (Extend, intervals.go:88-97 — note: closed-touch merges too);
- ``overlap`` uses the same boundary conventions as intervals.go:146-159
  (interval_start > end-1 / interval_end <= start-1);
- ``intersect`` matches intervals.go:163-173.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

Ivals = np.ndarray  # shape [n, 2] int32 (start, end)

ELSITES_HEADER = b"# elsites format version 1.0\n"


def make(starts, ends) -> Ivals:
    return np.stack(
        [np.asarray(starts, np.int32), np.asarray(ends, np.int32)], axis=1
    ).reshape(-1, 2)


def sort_by_start(ivals: Ivals) -> Ivals:
    order = np.argsort(ivals[:, 0], kind="stable")
    return ivals[order]


def flatten(ivals: Ivals) -> Ivals:
    """Merge overlapping (or touching, next.start <= cur.end) intervals;
    input must be sorted by start (reference: intervals.go:99-141)."""
    n = len(ivals)
    if n <= 1:
        return ivals
    starts = ivals[:, 0]
    ends = np.maximum.accumulate(ivals[:, 1])
    # a new group starts where start > running max end of previous
    new_group = np.ones(n, bool)
    new_group[1:] = starts[1:] > ends[:-1]
    gid = np.cumsum(new_group) - 1
    ngroups = gid[-1] + 1
    out_start = starts[new_group]
    out_end = np.zeros(ngroups, np.int32)
    np.maximum.at(out_end, gid, ivals[:, 1])
    return make(out_start, out_end)


def overlap(ivals: Optional[Ivals], start: int, end: int) -> bool:
    """Binary search overlap check (reference: intervals.go:146-159)."""
    if ivals is None or len(ivals) == 0:
        return False
    # find candidates: interval_start <= end-1 and interval_end > start-1
    idx = np.searchsorted(ivals[:, 0], end - 1, side="right")
    if idx == 0:
        return False
    # since flattened+sorted, ends are increasing; find first end > start-1
    jdx = np.searchsorted(ivals[:, 1], start - 1, side="right")
    return jdx < idx


def intersect(ivals: Ivals, start: int, end: int) -> Ivals:
    """All intervals overlapping [start, end] (reference: intervals.go:163-173)."""
    if ivals is None or len(ivals) == 0:
        return make([], [])
    lo = np.searchsorted(ivals[:, 1], start, side="left")
    hi = np.searchsorted(ivals[:, 0], end, side="right")
    return ivals[lo:hi]


def from_bed(bed) -> Dict[str, Ivals]:
    """(reference: intervals.go:257-267)"""
    out: Dict[str, Ivals] = {}
    for chrom, regions in bed.items():
        out[chrom] = make([r[0] for r in regions], [r[1] for r in regions])
    return out


def to_elsites_file(intervals: Dict[str, Ivals], filename: str) -> None:
    """(reference: intervals.go:179-196)"""
    with open(filename, "wb") as f:
        f.write(ELSITES_HEADER)
        for chrom, ivals in intervals.items():
            buf = bytearray()
            for s, e in ivals:
                buf += b"%s\t%d\t%d\n" % (chrom.encode(), s, e)
            f.write(buf)


def from_elsites_file(filename: str) -> Dict[str, Ivals]:
    """(reference: intervals.go:199-254)"""
    with open(filename, "rb") as f:
        header = f.readline()
        if header != ELSITES_HEADER:
            raise ValueError(f"{filename} is not a .elsites file - invalid header")
        chroms: Dict[str, Tuple[list, list]] = {}
        for line in f:
            line = line.rstrip(b"\n")
            if not line:
                continue
            parts = line.split(b"\t")
            if len(parts) != 3:
                raise ValueError(f"invalid sites line {line!r}")
            chrom = parts[0].decode()
            lst = chroms.setdefault(chrom, ([], []))
            lst[0].append(int(parts[1]))
            lst[1].append(int(parts[2]))
    return {c: make(s, e) for c, (s, e) in chroms.items()}
