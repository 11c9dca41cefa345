"""Optical duplicate marking and Picard DuplicationMetrics.

Reference: filters/mark-optical-duplicates.go. The reference runs a
second pass over the in-memory Sam with fork-join counter merges
(:469-525), re-joins duplicate pairs through a concurrent map, attaches
them to their "origin" pair (the dedup winner) via lock-free cons lists
(:303-321), and counts opticals per origin with either a <4 brute force
(:330-368) or a union-find cluster graph over reads in the same
(readgroup, tile) whose pixel distance is within threshold (:226-273;
graph.go:48-85).

Here the counters are vectorized bincounts over the library column, the
pair re-join/grouping is a numpy lexsort replay of the dedup kernel's
grouping, and union-find runs per multi-pair group on the host. The <4
brute force (including its early exit at ctr==2) computes exactly
``len - #clusters``, so union-find reproduces it for every group size.

Tile info comes from 5- or 7-column Illumina QNAMEs (:50-71); metrics
derivation (library-size bisection :535-569, ROI histogram :577-588) and
the Picard-format metrics file (:607-699) match the reference, with JSON
replacing gob for the sfm intermediate form (:701-731).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.batch import (
    DUPLICATE,
    FIRST,
    MULTIPLE,
    NEXT_UNMAPPED,
    REVERSED,
    SECONDARY,
    SUPPLEMENTARY,
    UNMAPPED,
    ReadBatch,
)
from ..core.header import Header

UNDEFINED_LIBRARY = "Unknown Library"
DEFAULT_PIXEL_DISTANCE = 100


@dataclass
class DuplicatesCtr:
    """(reference: mark-optical-duplicates.go:98-110)"""

    UnpairedReadsExamined: int = 0
    ReadPairsExamined: int = 0
    SecondaryOrSupplementaryReads: int = 0
    UnmappedReads: int = 0
    UnpairedReadDuplicates: int = 0
    ReadPairDuplicates: int = 0
    ReadPairOpticalDuplicates: int = 0
    percentDuplication: float = 0.0
    estimatedLibrarySize: int = 0
    histogram: List[float] = field(default_factory=list)
    duplicatesCountHistogram: Dict[int, int] = field(default_factory=dict)
    nonOpticalDuplicatesCountHistogram: Dict[int, int] = field(default_factory=dict)
    opticalDuplicatesCountHistogram: Dict[int, int] = field(default_factory=dict)


def parse_tile_info(qname: bytes) -> Tuple[int, int, int]:
    """Tile/x/y from a 5- or 7-column Illumina QNAME
    (reference: mark-optical-duplicates.go:50-71)."""
    cols = qname.split(b":")
    try:
        if len(cols) == 7:
            return int(cols[4]), int(cols[5]), int(cols[6])
        if len(cols) == 5:
            return int(cols[2]), int(cols[3]), int(cols[4])
    except ValueError:
        pass
    return -1, -1, -1


def _union_find_count(rg: List[bytes], tile: np.ndarray, x: np.ndarray, y: np.ndarray,
                      dist: int) -> int:
    """#duplicate relations = n - #clusters of the optical-distance graph
    (reference: countOpticalDuplicatesWithGraph + graph.cluster)."""
    n = len(tile)
    if n < 2:
        return 0
    if n > 300000:  # (reference: mark-optical-duplicates.go:330-333)
        return 0
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # group by (rg, tile); only valid tiles participate
    groups: Dict[Tuple[bytes, int], List[int]] = {}
    for i in range(n):
        if tile[i] != -1:
            groups.setdefault((rg[i], int(tile[i])), []).append(i)
    from .. import pedantic

    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        gx = x[idxs]
        gy = y[idxs]
        if pedantic.enabled:
            # int16 coordinate wraparound like Picard
            # (reference: pedantic.go:54-56)
            gx = gx.astype(np.int16).astype(np.int64)
            gy = gy.astype(np.int16).astype(np.int64)
        for a in range(len(idxs)):
            for b in range(a + 1, len(idxs)):
                if abs(int(gx[a]) - int(gx[b])) <= dist and abs(int(gy[a]) - int(gy[b])) <= dist:
                    ra, rb = find(idxs[a]), find(idxs[b])
                    if ra != rb:
                        parent[ra] = rb
    roots = {find(i) for i in range(n)}
    return n - len(roots)


def mark_optical_duplicates(
    batch: ReadBatch,
    header: Header,
    aux: dict,
    pixel_distance: int = DEFAULT_PIXEL_DISTANCE,
) -> Dict[str, DuplicatesCtr]:
    """Compute duplication metrics incl. optical counts
    (reference: MarkOpticalDuplicates, mark-optical-duplicates.go:469-525).

    ``aux`` is the dict returned by ops.dedup.mark_duplicates_batch
    (libid/upos/score/qrank columns).
    """
    n = len(batch)
    flag = batch.flag
    libid = aux["libid"]
    upos = aux["upos"]
    score = aux["score"]
    qrank = aux["qrank"]
    refid = batch.temps["REFID"]

    # library-name table: libid ints were assigned in @RG order by the
    # dedup pass; rebuild the same mapping (dedup.mark_duplicates_batch)
    lb_names: List[str] = []
    seen: Dict[str, int] = {}
    for rg_entry in header.rg:
        lb = rg_entry.get("LB")
        if lb is not None and lb not in seen:
            seen[lb] = len(lb_names)
            lb_names.append(lb)

    ctrs: Dict[str, DuplicatesCtr] = {UNDEFINED_LIBRARY: DuplicatesCtr()}
    for lb in lb_names:
        ctrs[lb] = DuplicatesCtr()

    def lib_name(lid: int) -> str:
        return lb_names[lid] if lid >= 0 else UNDEFINED_LIBRARY

    nlibs = len(lb_names) + 1  # slot 0 = Unknown Library
    lib_slot = np.where(libid >= 0, libid + 1, 0)

    unmapped = (flag & UNMAPPED) != 0
    secsup = ~unmapped & ((flag & (SECONDARY | SUPPLEMENTARY)) != 0)
    examined = ~unmapped & ~secsup
    true_pair = examined & ((flag & (MULTIPLE | NEXT_UNMAPPED)) == MULTIPLE)
    true_frag = examined & ~true_pair
    dup = (flag & DUPLICATE) != 0

    def count(mask: np.ndarray) -> np.ndarray:
        return np.bincount(lib_slot[mask], minlength=nlibs)

    c_unmapped = count(unmapped)
    c_secsup = count(secsup)
    c_frag = count(true_frag)
    c_pair = count(true_pair)
    c_frag_dup = count(true_frag & dup)

    for slot in range(nlibs):
        name = UNDEFINED_LIBRARY if slot == 0 else lb_names[slot - 1]
        ctr = ctrs[name]
        ctr.UnmappedReads = int(c_unmapped[slot])
        ctr.SecondaryOrSupplementaryReads = int(c_secsup[slot])
        ctr.UnpairedReadsExamined = int(c_frag[slot])
        ctr.ReadPairsExamined = int(c_pair[slot]) // 2
        ctr.UnpairedReadDuplicates = int(c_frag_dup[slot])

    # ------------------------------------------------------------------
    # re-join true pairs by {LIBID, QNAME} in arrival order, canonical
    # ordering, group by the dedup pair key (mirrors ops/dedup.py)
    # ------------------------------------------------------------------
    idx = np.arange(n)
    cand = np.flatnonzero(true_pair)
    if len(cand):
        order = np.lexsort((idx[cand], qrank[cand], libid[cand]))
        s = cand[order]
        # run boundaries on (libid, qrank)
        new_run = np.ones(len(s), bool)
        new_run[1:] = (libid[s][1:] != libid[s][:-1]) | (qrank[s][1:] != qrank[s][:-1])
        run_start = np.maximum.accumulate(np.where(new_run, np.arange(len(s)), 0))
        pos_in_run = np.arange(len(s)) - run_start
        second = pos_in_run % 2 == 1
        a = s[second]          # later arrival in join order
        b = s[np.flatnonzero(second) - 1]  # its predecessor
    else:
        a = b = np.zeros(0, np.int64)

    # canonical order (mark-duplicates.go:343-353)
    swap = (refid[a] > refid[b]) | (
        (refid[a] == refid[b])
        & ((upos[a] > upos[b]) | ((upos[a] == upos[b])
           & ((flag[a] & REVERSED) != 0) & ((flag[b] & REVERSED) == 0)))
    )
    ia = np.where(swap, b, a)  # aln1
    ib = np.where(swap, a, b)  # aln2
    p_lib = libid[ia]
    p_r1, p_r2 = refid[ia], refid[ib]
    p_o1, p_o2 = upos[ia], upos[ib]
    p_v1 = (flag[ia] & REVERSED) >> 4
    p_v2 = (flag[ib] & REVERSED) >> 4
    p_score = score[ia] + score[ib]
    p_q = qrank[ia]
    p_arr = np.maximum(ia, ib)
    p_dup = dup[ia]

    npairs = len(ia)
    dup_pair_counts = np.bincount(lib_slot[ia[p_dup]], minlength=nlibs) if npairs else np.zeros(nlibs, np.int64)
    for slot in range(nlibs):
        name = UNDEFINED_LIBRARY if slot == 0 else lb_names[slot - 1]
        ctrs[name].ReadPairDuplicates = int(dup_pair_counts[slot])

    if npairs:
        gorder = np.lexsort((-p_arr, p_q, -p_score, p_v2, p_v1, p_o2, p_o1, p_r2, p_r1, p_lib))
        g = gorder
        key_cols = (p_lib[g], p_r1[g], p_r2[g], p_o1[g], p_o2[g], p_v1[g], p_v2[g])
        change = np.zeros(npairs, bool)
        for k in key_cols:
            change[1:] |= k[1:] != k[:-1]
        change[0] = True
        grp_starts = np.flatnonzero(change)
        grp_ends = np.append(grp_starts[1:], npairs)

        # representative read per pair: the FIRST-flagged mate
        # (mark-optical-duplicates.go:218-224, 280-300)
        rep = np.where((flag[ia] & FIRST) != 0, ia, ib)
        rep_rev = (flag[rep] & REVERSED) != 0
        rg_vals = batch.tags.extract_z(b"RG")

        qname_bytes = batch.qname.astype(bytes)
        tile_cache: Dict[bytes, Tuple[int, int, int]] = {}

        def tile_of(read_i: int) -> Tuple[int, int, int]:
            qn = qname_bytes[read_i]
            t = tile_cache.get(qn)
            if t is None:
                t = parse_tile_info(qn)
                tile_cache[qn] = t
            return t

        for gs, ge in zip(grp_starts, grp_ends):
            members = g[gs:ge]  # winner first (sorted by score desc within group)
            lib = lib_name(int(p_lib[members[0]]))
            ctr = ctrs[lib]
            hists = (
                ctr.duplicatesCountHistogram,
                ctr.nonOpticalDuplicatesCountHistogram,
                ctr.opticalDuplicatesCountHistogram,
            )
            dup_count = len(members)
            if dup_count == 1:
                hists[0][1] = hists[0].get(1, 0) + 1
                hists[1][1] = hists[1].get(1, 0) + 1
                continue
            # forward/reverse split of representative reads, origin first
            fwd: List[int] = []
            rev_l: List[int] = []
            for m in members:
                r = int(rep[m])
                lst = rev_l if rep_rev[m] else fwd
                # build cap at 300001 entries (reference: :286-298)
                if len(lst) <= 300000:
                    lst.append(r)
            optical = 0
            for lst in (fwd, rev_l):
                if not lst:
                    continue
                tiles = np.array([tile_of(r) for r in lst], np.int64).reshape(len(lst), 3)
                optical += _union_find_count(
                    [rg_vals[r] for r in lst], tiles[:, 0], tiles[:, 1], tiles[:, 2],
                    pixel_distance,
                )
            ctr.ReadPairOpticalDuplicates += optical
            index1 = dup_count
            index2 = dup_count - optical if dup_count - optical > 0 else 0
            index3 = optical + 1 if optical > 0 else 0
            hists[0][index1] = hists[0].get(index1, 0) + 1
            if index2 > 0:
                hists[1][index2] = hists[1].get(index2, 0) + 1
            if index3 > 0:
                hists[2][index3] = hists[2].get(index3, 0) + 1

    for ctr in ctrs.values():
        calculate_derived_metrics(ctr)
    return ctrs


# ---------------------------------------------------------------------------
# Derived metrics (reference: mark-optical-duplicates.go:527-588)
# ---------------------------------------------------------------------------


def _f(x: float, c: float, n: float) -> float:
    return c / x - 1 + math.exp(-n / x)


def estimate_library_size(n_pairs: int, n_unique_pairs: int) -> int:
    """Bisection of c/x - 1 + e^(-n/x) (reference: :541-569)."""
    n = float(n_pairs)
    c = float(n_unique_pairs)
    n_dup = n_pairs - n_unique_pairs
    if n_pairs > 0 and n_dup > 0:
        m, M = 1.0, 100.0
        while _f(M * c, c, n) >= 0.0:
            M *= 10.0
        for _ in range(40):
            r = (m + M) / 2.0
            u = _f(r * c, c, n)
            if u == 0.0:
                break
            if u > 0.0:
                m = r
            if u < 0.0:
                M = r
        return int(c * ((m + M) / 2.0))
    return 0


def estimate_roi(est_size: int, x: int, n_pairs: int, n_unique_pairs: int) -> float:
    # IEEE float division like Go (x/0 = ±Inf, 0/0 = NaN), no exceptions
    with np.errstate(divide="ignore", invalid="ignore"):
        e = float(np.float64(-float(x * n_pairs)) / np.float64(est_size))
        val = est_size * (1.0 - math.exp(e)) if not math.isnan(e) else float("nan")
        return float(np.float64(val) / np.float64(n_unique_pairs))


def histogram_roi(ctr: DuplicatesCtr) -> List[float]:
    n_unique = ctr.ReadPairsExamined - ctr.ReadPairDuplicates
    return [
        estimate_roi(ctr.estimatedLibrarySize, x, ctr.ReadPairsExamined, n_unique)
        for x in range(1, 101)
    ]


def calculate_derived_metrics(ctr: DuplicatesCtr) -> None:
    if ctr.ReadPairsExamined > 0:
        ctr.estimatedLibrarySize = estimate_library_size(
            ctr.ReadPairsExamined - ctr.ReadPairOpticalDuplicates,
            ctr.ReadPairsExamined - ctr.ReadPairDuplicates,
        )
        ctr.histogram = histogram_roi(ctr)
    denom = ctr.UnpairedReadsExamined + ctr.ReadPairsExamined * 2
    num = ctr.UnpairedReadDuplicates + ctr.ReadPairDuplicates * 2
    ctr.percentDuplication = num / denom if denom else float("nan")


# ---------------------------------------------------------------------------
# Output (reference: mark-optical-duplicates.go:607-731)
# ---------------------------------------------------------------------------


def format_float(v: float) -> str:
    """Go's %.6f with trailing zeros stripped unless all-zero fraction
    (reference: formatFloat, :590-605)."""
    if math.isnan(v):
        return "NaN"
    s = "%.6f" % v
    dot = s.find(".")
    if dot < 0:
        return s
    j = len(s) - 1
    while j > dot:
        if s[j] != "0":
            return s[: j + 1]
        j -= 1
    return s


def print_duplicates_metrics(path: str, command_line: str, ctrs: Dict[str, DuplicatesCtr],
                             now: Optional[str] = None) -> None:
    """Picard-format metrics file (reference: :607-699)."""
    import time as _time

    if now is None:
        now = _time.strftime("%a %b %d %H:%M:%S %Z %Y")
    lines: List[str] = []
    lines.append("## htsjdk.samtools.metrics.StringHeader")
    lines.append("# " + command_line)
    lines.append("## htsjdk.samtools.metrics.StringHeader")
    lines.append("# Started on: " + now)
    lines.append("")
    lines.append("## METRICS CLASS\tpicard.sam.DuplicationMetrics")
    lines.append(
        "LIBRARY\tUNPAIRED_READS_EXAMINED\tREAD_PAIRS_EXAMINED\tSECONDARY_OR_SUPPLEMENTARY_RDS"
        "\tUNMAPPED_READS\tUNPAIRED_READ_DUPLICATES\tREAD_PAIR_DUPLICATES"
        "\tREAD_PAIR_OPTICAL_DUPLICATES\tPERCENT_DUPLICATION\tESTIMATED_LIBRARY_SIZE"
    )
    for library, ctr in ctrs.items():
        row = (
            f"{library}\t{ctr.UnpairedReadsExamined}\t{ctr.ReadPairsExamined}"
            f"\t{ctr.SecondaryOrSupplementaryReads}\t{ctr.UnmappedReads}"
            f"\t{ctr.UnpairedReadDuplicates}\t{ctr.ReadPairDuplicates}"
            f"\t{ctr.ReadPairOpticalDuplicates}\t{format_float(ctr.percentDuplication)}"
        )
        if ctr.ReadPairsExamined > 0:
            row += f"\t{ctr.estimatedLibrarySize}"
        lines.append(row)
    lines.append("")

    # histogram only when exactly one library has pairs (reference: :661-671)
    with_pairs = [c for c in ctrs.values() if c.ReadPairsExamined > 0]
    if len(with_pairs) == 1:
        ctr = with_pairs[0]
        lines.append("## HISTOGRAM\tjava.lang.Double")
        lines.append("BIN\tCoverageMult\tall_sets\toptical_sets\tnon_optical_sets")
        for i, h in enumerate(ctr.histogram):
            lines.append(
                f"{i + 1}.0\t{format_float(h)}\t{ctr.duplicatesCountHistogram.get(i + 1, 0)}"
                f"\t{ctr.opticalDuplicatesCountHistogram.get(i + 1, 0)}"
                f"\t{ctr.nonOpticalDuplicatesCountHistogram.get(i + 1, 0)}"
            )
        overflow = sorted(
            k for k in set(ctr.duplicatesCountHistogram)
            | set(ctr.opticalDuplicatesCountHistogram)
            | set(ctr.nonOpticalDuplicatesCountHistogram)
            if k > 100
        )
        for k in overflow:
            lines.append(
                f"{k}.0\t0\t{ctr.duplicatesCountHistogram.get(k, 0)}"
                f"\t{ctr.opticalDuplicatesCountHistogram.get(k, 0)}"
                f"\t{ctr.nonOpticalDuplicatesCountHistogram.get(k, 0)}"
            )
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


# sfm intermediate form: JSON replaces the reference's gob (:701-731)


_CTR_COUNTERS = (
    "UnpairedReadsExamined", "ReadPairsExamined",
    "SecondaryOrSupplementaryReads", "UnmappedReads",
    "UnpairedReadDuplicates", "ReadPairDuplicates",
    "ReadPairOpticalDuplicates",
)
_CTR_HISTOGRAMS = (
    "duplicatesCountHistogram", "nonOpticalDuplicatesCountHistogram",
    "opticalDuplicatesCountHistogram",
)


def save_metrics_intermediate(path: str, ctrs: Dict[str, DuplicatesCtr]) -> None:
    """Intermediate form for the sfm-style merge: the additive counters
    AND the duplicate-set-size histograms (the reference gob-encodes the
    full ctr and merges histograms element-wise,
    mark-optical-duplicates.go:119-129,701-731)."""
    data = {
        lib: dict(
            {k: getattr(c, k) for k in _CTR_COUNTERS},
            **{k: {str(sz): cnt for sz, cnt in getattr(c, k).items()}
               for k in _CTR_HISTOGRAMS},
        )
        for lib, c in ctrs.items()
    }
    with open(path, "w") as fh:
        json.dump(data, fh)


def load_and_combine_metrics(paths: List[str]) -> Dict[str, DuplicatesCtr]:
    """(reference: LoadAndCombineDuplicateMetrics, :713-731): counters
    sum, histograms merge element-wise, derived metrics recompute."""
    ctrs: Dict[str, DuplicatesCtr] = {}
    for p in paths:
        with open(p) as fh:
            data = json.load(fh)
        for lib, vals in data.items():
            ctr = ctrs.setdefault(lib, DuplicatesCtr())
            for k, v in vals.items():
                if k in _CTR_HISTOGRAMS:
                    hist = getattr(ctr, k)
                    for sz, cnt in v.items():
                        hist[int(sz)] = hist.get(int(sz), 0) + cnt
                else:
                    setattr(ctr, k, getattr(ctr, k) + v)
    for ctr in ctrs.values():
        calculate_derived_metrics(ctr)
    return ctrs
