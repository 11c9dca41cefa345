"""BED file parsing (reference: bed/bed-files.go, bed/bed-types.go).

A Bed is an insertion-ordered dict chrom -> list of (start, end,
optional_fields) tuples, with regions stably sorted by start per chrom
(reference: bed-files.go:33-62 sortRegions). Optional fields are
validated like initializeRegionFields (bed-types.go:81-118).
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

Region = Tuple[int, int, list]
Bed = Dict[str, List[Region]]


def _parse_optional_fields(fields: List[str]) -> list:
    """(reference: bed/bed-types.go:81-118)"""
    out: list = []
    for i, val in enumerate(fields):
        if i == 0:  # name
            out.append(val)
        elif i == 1:  # score
            score = int(val)
            if score < 0 or score > 1000:
                raise ValueError(f"invalid Score field : {score}")
            out.append(score)
        elif i == 2:  # strand
            if val not in ("+", "-"):
                raise ValueError(f"invalid Strand field: {val}")
            out.append(val)
        elif i in (3, 4, 6, 7, 8):  # thickStart/thickEnd/blockCount/Sizes/Starts
            out.append(int(val))
        elif i == 5:  # itemRgb
            out.append(val == "on")
        else:
            raise ValueError(f"invalid optional field: {val} out of 0-8")
    return out


def parse_bed(filename: str) -> Bed:
    """(reference: bed/bed-files.go:33-62)"""
    opener = gzip.open if _is_gzip(filename) else open
    bed: Bed = {}
    with opener(filename, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            data = line.split("\t")
            chrom = data[0]
            start = int(data[1])
            end = int(data[2])
            bed.setdefault(chrom, []).append((start, end, _parse_optional_fields(data[3:])))
    for chrom in bed:
        bed[chrom].sort(key=lambda r: r[0])  # stable sort by start
    return bed


def _is_gzip(filename: str) -> bool:
    with open(filename, "rb") as f:
        return f.read(1) == b"\x1f"
