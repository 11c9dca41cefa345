"""Activity model and assembly-region decomposition
(reference: filters/pileup.go, filters/haplotypecaller.go:100-443).

The reference walks per-read cursors building one pileup per reference
position and evaluates ref-vs-any diploid genotype likelihoods per
pileup (pileup.go:180-554). Here the pileup is flattened columnwise:
every ref-consuming (read, position) pair becomes one row of a flat
element table with per-element flags (alt-before-assembly, soft-clip
adjacency, effective qual), and each position's likelihoods are ordered
segment reductions (numpy reduceat) over the read-ordered rows — the
same per-element evaluation order as the reference's sequential loop.

Downsampling uses a Java-compatible LCG (reference: internal/pedantic.go
NewRand(47382911); haploutils.go:301-341) so read selection matches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..filters.clipping import (
    ClipRead,
    compute_adaptor_boundary,
    compute_read_coordinate_for_reference_coordinate,
    hard_clip_adaptor_sequence,
    hard_clip_low_qual_ends,
    hard_clip_soft_clipped_bases,
    hard_clip_to_region,
    has_well_defined_fragment_size,
    is_strict_unmapped,
    read_length_from_cigar,
    reference_length_from_cigar,
    revert_soft_clipped_bases,
    soft_start,
)
from . import tables

LOG10_ONE = 0.0
LOG10_PLOIDY = 0.3010299956639812
LOG10_ONE_THIRD = -0.47712125471966244

HIGH_QUALITY_SOFT_CLIP_THRESHOLD = 28
AVERAGE_HQ_SOFT_CLIPS_THRESHOLD = 6

PCR_SNV_ERROR_QUAL = round(-10 * math.log10(1e-4))
HALF_PCR_SNV_ERROR_QUAL = PCR_SNV_ERROR_QUAL // 2

READ_LENGTH_FILTER_THRESHOLD = 10
READ_QUALITY_FILTER_THRESHOLD = 20


def go_round(x: float) -> float:
    """Go math.Round: half away from zero."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def log1mexp(a: float) -> float:
    if a > 0:
        return float("nan")
    if a == 0:
        return float("-inf")
    if a < math.log(0.5):
        return math.log1p(-math.exp(a))
    return math.log(-math.expm1(a))


def log10_one_minus_pow10(a: float) -> float:
    if a > 0:
        return float("nan")
    if a == 0:
        return float("-inf")
    return log1mexp(a * math.log(10)) / math.log(10)


class JavaRandom:
    """java.util.Random-compatible LCG (reference: internal/pedantic.go:33-84)."""

    MULT = 0x5DEECE66D
    ADD = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 47382911) -> None:
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        self.seed = (seed ^ self.MULT) & self.MASK

    def reflect_seed(self) -> int:
        """Raw internal seed for --random-seed-file round-trips."""
        return self.seed

    @classmethod
    def from_reflect(cls, raw: int) -> "JavaRandom":
        r = cls(0)
        r.seed = raw & cls.MASK
        return r

    def _next(self, bits: int) -> int:
        self.seed = (self.seed * self.MULT + self.ADD) & self.MASK
        return self.seed >> (48 - bits)

    def int31n(self, n: int) -> int:
        """java.util.Random.nextInt(n)."""
        if n <= 0:
            raise ValueError("n must be positive")
        if n & (n - 1) == 0:
            return (n * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % n
            if bits - val + (n - 1) < (1 << 31):
                return val


@dataclass
class HCParams:
    """(reference: NewHaplotypeCaller, haplotypecaller.go:202-284)"""

    confidence_mode: str = "NONE"  # NONE | GVCF | BP_RESOLUTION
    active_prob_threshold: float = 0.002
    max_prob_propagation_distance: int = 50 + len(tables.GAUSSIAN_KERNEL) // 2
    min_region_size: int = 50
    max_region_size: int = 300
    padding: int = 100
    min_base_qual: int = 10
    ref_pseudocount: float = 0.0
    snp_pseudocount: float = 0.0
    indel_pseudocount: float = 0.0
    log10_priors: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    log10_acgt0_prior: float = 0.0
    standard_confidence_for_calling: float = 30.0
    standard_confidence_for_calling_by_min10: float = -3.0
    standard_confidence_for_activity_by_min10: float = -0.4
    max_reads_per_alignment_start: int = 50
    indel_size_to_eliminate_in_ref_model: int = 10
    use_soft_clipped_bases: bool = True
    gq_bands: List[int] = field(default_factory=list)
    random: JavaRandom = field(default_factory=JavaRandom)
    sample_name: str = ""
    command_line: str = ""
    # --randomized-qd: carried in params so spawned HC workers apply the
    # same mode (module state does not cross process boundaries)
    randomized_qd: bool = False
    # set by downsample/downsample_block the moment the Java-LCG stream
    # is consumed: a multi-host run uses it to warn that per-slice
    # streams diverge from a whole-file run's single stream
    # (parallel/multihost.py module docstring; cmd/sfm.go:634-644)
    downsample_fired: bool = False


def make_hc_params(reference_confidence: str = "NONE",
                   assembly_region_padding: int = 100,
                   random_seed: Optional[int] = None,
                   command_line: str = "") -> HCParams:
    if reference_confidence == "NONE":
        std_conf = 30.0
    elif reference_confidence in ("GVCF", "BP_RESOLUTION"):
        std_conf = -0.0
    else:
        raise ValueError(f"invalid reference confidence mode {reference_confidence}")
    std_conf_activity = min(4.0, std_conf)

    heterozygosity = 0.001
    indel_heterozygosity = 1.25e-4
    heterozygosity_stddev = 0.01
    log10_het = math.log10(heterozygosity)
    p1 = log10_het - math.log10(1)
    p2 = log10_het - math.log10(2)
    log10_sum = tables.approximate_log10_sum_log10(p1, p2)
    if log10_sum >= 0:
        raise ValueError("heterozygosity too large for total ploidy 2")
    p0 = log10_one_minus_pow10(log10_sum)
    ref_pseudo = heterozygosity / heterozygosity_stddev ** 2
    rnd = JavaRandom() if random_seed is None else JavaRandom(random_seed)
    return HCParams(
        confidence_mode={"NONE": "NONE", "GVCF": "GVCF", "BP_RESOLUTION": "BP_RESOLUTION"}[reference_confidence],
        padding=assembly_region_padding,
        log10_priors=(p0, p1, p2),
        log10_acgt0_prior=tables.approximate_log10_sum_log10(p1, p2),
        ref_pseudocount=ref_pseudo,
        snp_pseudocount=heterozygosity * ref_pseudo,
        indel_pseudocount=indel_heterozygosity * ref_pseudo,
        standard_confidence_for_calling=std_conf,
        standard_confidence_for_calling_by_min10=std_conf / -10,
        standard_confidence_for_activity_by_min10=std_conf_activity / -10,
        gq_bands=list(range(60)) + [60, 70, 80, 90, 99, 100],
        random=rnd,
        command_line=command_line,
    )


# ---------------------------------------------------------------------------
# Read-list helpers (reference: haploutils.go:191-366)
# ---------------------------------------------------------------------------


def read_end(r: ClipRead) -> int:
    return r.pos + reference_length_from_cigar(r.cigar) - 1


def aln_slice(reads: List[ClipRead], region_start: int, region_end: int,
              max_reference_length: int,
              positions: "np.ndarray | None" = None) -> Tuple[List[ClipRead], int]:
    """(reference: haploutils.go:191-209). Pass a precomputed ``positions``
    array when slicing the same read list repeatedly — rebuilding it per
    call makes region iteration quadratic."""
    lowest = region_start - max_reference_length + 1
    if positions is None:
        positions = np.fromiter((r.pos for r in reads), np.int64, len(reads))
    j = int(np.searchsorted(positions, lowest, side="left"))
    k = int(np.searchsorted(positions, region_end, side="right"))
    result = []
    first_index = 0
    for i in range(j, k):
        r = reads[i]
        if read_end(r) >= region_start:
            if not result:
                first_index = i
            result.append(r)
    return result, first_index


def max_reference_length(reads: List[ClipRead]) -> int:
    return max((reference_length_from_cigar(r.cigar) for r in reads), default=0)


def downsample(reads: List[ClipRead], params: HCParams) -> List[ClipRead]:
    """Deterministic 50-reads-per-start downsampler with the Java LCG
    (reference: haploutils.go:241-275)."""
    maxn = params.max_reads_per_alignment_start
    if maxn < 1:
        return reads
    out: List[ClipRead] = []
    pos = 1
    total = 0
    cur: List[ClipRead] = []
    for r in reads:
        if r.pos == pos:
            total += 1
            if total <= maxn:
                cur.append(r)
            else:
                params.downsample_fired = True
                slot = params.random.int31n(total)
                if slot < maxn:
                    cur[slot] = r
        else:
            out.extend(cur)
            pos = r.pos
            total = 1
            cur = [r]
    out.extend(cur)
    return out


def read_overlaps_region(r: ClipRead, region_start: int, region_end: int) -> bool:
    if len(r.seq) == 0:
        return False
    start, end = r.pos, read_end(r)
    if start > end:
        return False
    return start <= region_end and region_start <= end


# ---------------------------------------------------------------------------
# Flat pileup-element expansion (pileup.go cursor semantics, columnized)
# ---------------------------------------------------------------------------


def count_high_quality_soft_clips(r: ClipRead) -> int:
    """(reference: pileup.go:33-48)"""
    result = 0
    align_pos = 0
    for length, op in r.cigar:
        if op == "S":
            for i in range(length):
                if r.qual[align_pos + i] > HIGH_QUALITY_SOFT_CLIP_THRESHOLD:
                    result += 1
            align_pos += length
        elif op in "MI=X":
            align_pos += length
    return result


_GENOME_OPS = frozenset("M=XD")


def expand_elements(reads: List[ClipRead], low: int, high: int):
    """Per-(read, refpos) element table for positions in [low, high).

    Returns dict of flat arrays sorted by (refpos, read order):
    refpos, read_idx, qual_eff, base, is_del, alt, next_to_sc,
    keep (adaptor), hq_clips (per element, read-level count).

    Vectorized: a light prepass collects one scalar descriptor per
    (read, ref-consuming cigar op) segment, then ALL elements expand in
    a handful of numpy ops (np.repeat + flat gathers). Equivalent to
    the per-op loop `_expand_elements_py` below (kept as the oracle)."""
    seg_rows: List[tuple] = []
    _SEG_KEYS = ("ridx", "off0", "off1", "loc", "bi", "op", "oplen",
                 "pc", "nc", "pg", "ng", "hq", "keep_mode", "bound")
    flat_seq_parts: List[bytes] = []
    flat_qual_parts: List[bytes] = []
    seq_off: List[int] = []
    qual_off: List[int] = []
    seq_len: List[int] = []
    qual_len: List[int] = []
    so = qo = 0
    n_used = 0
    for ridx, r in enumerate(reads):
        if r.pos >= high:
            break
        n_used = ridx + 1
        flat_seq_parts.append(r.seq if len(r.seq) else b"\x00")
        flat_qual_parts.append(r.qual if len(r.qual) else b"\x00")
        seq_off.append(so)
        qual_off.append(qo)
        seq_len.append(len(r.seq))
        qual_len.append(len(r.qual))
        so += max(len(r.seq), 1)
        qo += max(len(r.qual), 1)
        hq = count_high_quality_soft_clips(r)
        if r.tlen > 100:
            keep_mode, bound = 0, 0
        else:
            boundary, _, well = compute_adaptor_boundary(r)
            if not well:
                keep_mode, bound = 0, 0
            else:
                keep_mode = 1 if r.is_reversed() else 2  # 1: pos>b, 2: pos<b
                bound = boundary
        n_ops = len(r.cigar)
        # per-op previous/next on-genome op chars, two sweeps
        prev_g = [0] * n_ops
        next_g = [0] * n_ops
        g = 0
        for ci in range(n_ops):
            prev_g[ci] = g
            if r.cigar[ci][1] in _GENOME_OPS:
                g = ord(r.cigar[ci][1])
        g = 0
        for ci in range(n_ops - 1, -1, -1):
            next_g[ci] = g
            if r.cigar[ci][1] in _GENOME_OPS:
                g = ord(r.cigar[ci][1])
        base_index = 0
        loc = r.pos
        for ci, (length, op) in enumerate(r.cigar):
            if op in "HP":
                continue
            if op in "IS":
                base_index += length
                continue
            if op not in _GENOME_OPS and op != "N":
                raise ValueError(f"invalid cigar op {op}")
            s = max(loc, low)
            e = min(loc + length, high)
            if e > s:
                seg_rows.append((
                    ridx, s - loc, e - loc, loc, base_index, ord(op), length,
                    ord(r.cigar[ci - 1][1]) if ci > 0 else 0,
                    ord(r.cigar[ci + 1][1]) if ci + 1 < n_ops else 0,
                    prev_g[ci], next_g[ci], hq, keep_mode, bound))
            loc += length
            if op in "M=X":
                base_index += length

    if not seg_rows:
        z = np.zeros(0, np.int64)
        return dict(refpos=z, read_idx=z, qual=z, base=z, alt=np.zeros(0, bool),
                    is_del=np.zeros(0, bool), next_to_sc=np.zeros(0, bool),
                    keep=np.zeros(0, bool), hq=z)

    seg_mat = np.array(seg_rows, np.int64)
    sa = {k: seg_mat[:, i] for i, k in enumerate(_SEG_KEYS)}
    lens = sa["off1"] - sa["off0"]
    total = int(lens.sum())
    sid = np.repeat(np.arange(len(lens)), lens)
    cum0 = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(total, dtype=np.int64) - cum0[sid]
    elem_off = sa["off0"][sid] + within          # offset within the op
    positions = sa["loc"][sid] + elem_off
    op_c = sa["op"][sid]
    oplen = sa["oplen"][sid]
    first_of_op = elem_off == 0
    last_of_op = elem_off == oplen - 1
    is_match_elem = (op_c == ord("M")) | (op_c == ord("=")) | (op_c == ord("X"))
    is_del_elem = op_c == ord("D")
    is_n_elem = op_c == ord("N")

    ridx_e = sa["ridx"][sid]
    flat_seq = np.frombuffer(b"".join(flat_seq_parts), np.uint8)
    flat_qual = np.frombuffer(b"".join(flat_qual_parts), np.uint8)
    seq_off_a = np.asarray(seq_off, np.int64)
    qual_off_a = np.asarray(qual_off, np.int64)
    seq_len_a = np.asarray(seq_len, np.int64)
    qual_len_a = np.asarray(qual_len, np.int64)

    bidx = np.where(is_match_elem, sa["bi"][sid] + elem_off, sa["bi"][sid] - 1)
    sl = seq_len_a[ridx_e]
    ql = qual_len_a[ridx_e]
    b_safe = np.clip(bidx, 0, np.maximum(sl - 1, 0))
    q_safe = np.clip(bidx, 0, np.maximum(ql - 1, 0))
    bases = flat_seq[seq_off_a[ridx_e] + b_safe].astype(np.int64)
    quals = flat_qual[qual_off_a[ridx_e] + q_safe].astype(np.int64)
    bases[sl == 0] = 0
    quals[ql == 0] = 0

    prev_char = np.where(first_of_op, sa["pc"][sid], op_c)
    next_char = np.where(last_of_op, sa["nc"][sid], op_c)
    prev_gen = np.where(is_n_elem, sa["pg"][sid],
                        np.where(first_of_op, sa["pg"][sid], op_c))
    next_gen = np.where(is_n_elem, sa["ng"][sid],
                        np.where(last_of_op, sa["ng"][sid], op_c))

    qual_eff = np.where(is_del_elem, 30, quals)
    alt = (
        is_del_elem
        | (prev_char == ord("I")) | (prev_char == ord("S"))
        | (next_char == ord("I")) | (next_char == ord("S"))
        | (prev_gen == ord("D")) | (next_gen == ord("D"))
    )
    next_to_sc = (prev_char == ord("S")) | (next_char == ord("S"))
    km = sa["keep_mode"][sid]
    bd = sa["bound"][sid]
    keep = np.where(km == 0, True,
                    np.where(km == 1, positions > bd, positions < bd))

    order = np.lexsort((ridx_e, positions))
    return dict(
        refpos=positions[order],
        read_idx=ridx_e[order],
        qual=qual_eff[order],
        base=bases[order],
        alt=alt[order],
        is_del=is_del_elem[order],
        next_to_sc=next_to_sc[order],
        keep=keep[order],
        hq=sa["hq"][sid][order],
    )


def _expand_elements_py(reads: List[ClipRead], low: int, high: int):
    """Per-(read, refpos) element table for positions in [low, high).

    Reference-shaped per-op loop — retained as the oracle for the
    vectorized expand_elements above.
    """
    refpos_l: List[np.ndarray] = []
    read_idx_l: List[np.ndarray] = []
    qual_l: List[np.ndarray] = []
    alt_l: List[np.ndarray] = []
    del_l: List[np.ndarray] = []
    sc_l: List[np.ndarray] = []
    keep_l: List[np.ndarray] = []
    hq_l: List[np.ndarray] = []

    for ridx, r in enumerate(reads):
        if r.pos >= high:
            break
        n_ops = len(r.cigar)
        hq = count_high_quality_soft_clips(r)
        # adaptor-filter read-level precomputation (pileup.go:252-278)
        if r.tlen > 100:
            keep_fn = None  # always keep
        else:
            boundary, _, well = compute_adaptor_boundary(r)
            if not well:
                keep_fn = None
            else:
                rev = r.is_reversed()
                keep_fn = (boundary, rev)
        base_index = 0
        loc = r.pos
        for ci, (length, op) in enumerate(r.cigar):
            if op in "HP":
                continue
            if op in "IS":
                base_index += length
                continue
            if op not in _GENOME_OPS and op != "N":
                raise ValueError(f"invalid cigar op {op}")
            # ref-consuming op covering [loc, loc+length)
            s = max(loc, low)
            e = min(loc + length, high)
            if e > s:
                offs = np.arange(s - loc, e - loc, dtype=np.int64)
                positions = loc + offs
                m = len(offs)
                is_match_op = op in "M=X"
                if is_match_op:
                    bidx = base_index + offs
                    quals = np.frombuffer(r.qual, np.uint8)[bidx].astype(np.int64)
                    bases = np.frombuffer(r.seq, np.uint8)[bidx].astype(np.int64)
                else:
                    bidx = np.full(m, base_index - 1, np.int64)
                    safe = np.clip(bidx, 0, max(len(r.qual) - 1, 0))
                    quals = (np.frombuffer(r.qual, np.uint8)[safe].astype(np.int64)
                             if len(r.qual) else np.zeros(m, np.int64))
                    bases = (np.frombuffer(r.seq, np.uint8)[safe].astype(np.int64)
                             if len(r.seq) else np.zeros(m, np.int64))
                is_del_op = op == "D"

                # the cursor's element offset within the op: offset 0 for
                # D/N positions beyond the first never occurs for
                # prev-op purposes (cigarOffset counts within the op)
                elem_off = offs  # offset within op for each element
                first_of_op = elem_off == 0
                last_of_op = elem_off == length - 1
                # immediate prev/next op chars (pileup.go:88-133)
                prev_char = np.full(m, ord(op), np.int64)
                prev_char[first_of_op] = ord(r.cigar[ci - 1][1]) if ci > 0 else 0
                next_char = np.full(m, ord(op), np.int64)
                next_char[last_of_op] = ord(r.cigar[ci + 1][1]) if ci + 1 < n_ops else 0
                # prev/next on-genome op chars (pileup.go:99-151): the
                # same op counts only if it is an on-genome kind
                pg = 0
                for k in range(ci - 1, -1, -1):
                    if r.cigar[k][1] in _GENOME_OPS:
                        pg = ord(r.cigar[k][1])
                        break
                ng = 0
                for k in range(ci + 1, n_ops):
                    if r.cigar[k][1] in _GENOME_OPS:
                        ng = ord(r.cigar[k][1])
                        break
                if op in _GENOME_OPS:
                    prev_gen = np.full(m, ord(op), np.int64)
                    prev_gen[first_of_op] = pg
                    next_gen = np.full(m, ord(op), np.int64)
                    next_gen[last_of_op] = ng
                else:  # 'N' op
                    prev_gen = np.full(m, pg, np.int64)
                    next_gen = np.full(m, ng, np.int64)

                qual_eff = np.where(is_del_op, 30, quals)
                alt = (
                    is_del_op
                    | (prev_char == ord("I")) | (prev_char == ord("S"))
                    | (next_char == ord("I")) | (next_char == ord("S"))
                    | (prev_gen == ord("D")) | (next_gen == ord("D"))
                )
                next_to_sc = (prev_char == ord("S")) | (next_char == ord("S"))
                if keep_fn is None:
                    keep = np.ones(m, bool)
                else:
                    boundary, rev = keep_fn
                    keep = positions > boundary if rev else positions < boundary
                refpos_l.append(positions)
                read_idx_l.append(np.full(m, ridx, np.int64))
                qual_l.append(qual_eff)
                alt_l.append(alt)
                del_l.append(np.full(m, is_del_op, bool))
                sc_l.append(next_to_sc)
                keep_l.append(keep)
                hq_l.append(np.full(m, hq, np.int64))
            loc += length
            if op in "M=X":
                base_index += length

    if not refpos_l:
        z = np.zeros(0, np.int64)
        return dict(refpos=z, read_idx=z, qual=z, base=z, alt=np.zeros(0, bool),
                    is_del=np.zeros(0, bool), next_to_sc=np.zeros(0, bool),
                    keep=np.zeros(0, bool), hq=z)
    refpos = np.concatenate(refpos_l)
    read_idx = np.concatenate(read_idx_l)
    order = np.lexsort((read_idx, refpos))
    out = dict(
        refpos=refpos[order],
        read_idx=read_idx[order],
        qual=np.concatenate(qual_l)[order],
        alt=np.concatenate(alt_l)[order],
        is_del=np.concatenate(del_l)[order],
        next_to_sc=np.concatenate(sc_l)[order],
        keep=np.concatenate(keep_l)[order],
        hq=np.concatenate(hq_l)[order],
    )
    # bases re-gather (same per-read logic, second pass kept simple)
    return out


def _expand_bases(reads: List[ClipRead], low: int, high: int) -> np.ndarray:
    """Bases column matching expand_elements order."""
    bases_l: List[np.ndarray] = []
    refpos_l: List[np.ndarray] = []
    ridx_l: List[np.ndarray] = []
    for ridx, r in enumerate(reads):
        if r.pos >= high:
            break
        base_index = 0
        loc = r.pos
        for length, op in r.cigar:
            if op in "HP":
                continue
            if op in "IS":
                base_index += length
                continue
            s = max(loc, low)
            e = min(loc + length, high)
            if e > s:
                offs = np.arange(s - loc, e - loc, dtype=np.int64)
                if op in "M=X":
                    bidx = base_index + offs
                else:
                    bidx = np.full(len(offs), base_index - 1, np.int64)
                safe = np.clip(bidx, 0, max(len(r.seq) - 1, 0))
                b = (np.frombuffer(r.seq, np.uint8)[safe].astype(np.int64)
                     if len(r.seq) else np.zeros(len(offs), np.int64))
                bases_l.append(b)
                refpos_l.append(loc + offs)
                ridx_l.append(np.full(len(offs), ridx, np.int64))
            loc += length
            if op in "M=X":
                base_index += length
    if not bases_l:
        return np.zeros(0, np.int64)
    refpos = np.concatenate(refpos_l)
    ridx = np.concatenate(ridx_l)
    order = np.lexsort((ridx, refpos))
    return np.concatenate(bases_l)[order]


def compute_activity(reads: List[ClipRead], reference: bytes, low: int, high: int,
                     params: HCParams) -> Tuple[np.ndarray, np.ndarray]:
    """isActive probability + hq-soft-clip mean per position in [low, high)
    (1-based positions; reference: pileup.go:470-554).

    Ordered segment reductions replicate the reference's per-element
    accumulation order (reads ascending within each position)."""
    n = high - low
    is_active = np.zeros(n, np.float64)
    hq_mean = np.zeros(n, np.float64)
    el = expand_elements(reads, low, high)
    if len(el["refpos"]) == 0:
        return is_active, hq_mean
    bases = el["base"]

    keep = el["keep"]
    qual = el["qual"]
    # include D elements always; skip qual <= minBaseQual otherwise
    # (pileup.go:474-480)
    usable = keep & (el["is_del"] | (qual > params.min_base_qual))
    refpos = el["refpos"][usable]
    qual = qual[usable]
    is_del = el["is_del"][usable]
    alt_flags = el["alt"][usable]
    next_to_sc = el["next_to_sc"][usable]
    hq = el["hq"][usable]
    bases = bases[usable]

    ref_arr = np.frombuffer(reference, np.uint8)
    ref_base = ref_arr[np.clip(refpos - 1, 0, len(ref_arr) - 1)].astype(np.int64)
    alt = alt_flags | (bases != ref_base)

    qual_c = np.clip(qual, 0, tables.MAX_QUAL)
    ref_lik = tables.QUAL_TO_PROB_LOG10[qual_c]
    nonref_lik = qual.astype(np.float64) / -10.0 + LOG10_ONE_THIRD
    rl = np.where(alt, nonref_lik, ref_lik)
    nl = np.where(alt, ref_lik, nonref_lik)

    # per-element terms (pileup.go:487-500)
    t0 = rl + LOG10_PLOIDY
    # approximateLog10SumLog10(rl+0, nl+0), vectorized table lookup
    big = np.maximum(rl, nl)
    small = np.minimum(rl, nl)
    diff = big - small
    idx = tables.jacobian_index(diff)
    t1 = np.where(
        np.isinf(small) | (diff >= tables.JACOBIAN_LOG_MAX_TOLERANCE),
        big,
        big + tables.JACOBIAN_LOG_TABLE[idx],
    )
    t2 = nl + LOG10_PLOIDY

    # position segmentation (rows sorted by refpos, read order)
    upos, starts = np.unique(refpos, return_index=True)
    gl0 = np.add.reduceat(t0, starts)
    gl1 = np.add.reduceat(t1, starts)
    gl2 = np.add.reduceat(t2, starts)
    counts = np.diff(np.append(starts, len(refpos)))
    ref_depth = np.add.reduceat((~alt).astype(np.int64), starts)
    denom = counts.astype(np.float64) * LOG10_PLOIDY
    gl0 -= denom
    gl1 -= denom
    gl2 -= denom

    # hq soft-clips running average per position (alt & next-to-softclip)
    hq_sel = alt & next_to_sc
    hq_means = np.zeros(len(upos), np.float64)
    if hq_sel.any():
        pos_of = np.searchsorted(upos, refpos[hq_sel])
        vals = hq[hq_sel].astype(np.float64)
        # incremental running average per group, order preserved
        for p in np.unique(pos_of):
            sel = vals[pos_of == p]
            mean = 0.0
            cnt = 0.0
            for v in sel:
                cnt += 1
                mean = mean + (v - mean) / cnt
            hq_means[p] = mean

    # posterior (pileup.go:512-554)
    gl = np.stack([gl0, gl1, gl2], axis=1)
    adjust = np.max(gl, axis=1, keepdims=True)
    adjusted = -10.0 * (gl - adjust)
    over = adjusted > np.iinfo(np.int32).max
    rounded = np.floor(adjusted + 0.5) / -10.0  # adjusted >= 0 always
    gl = np.where(over, np.iinfo(np.int32).max / -10.0, rounded)

    p0, p1, p2 = params.log10_priors
    post0 = gl[:, 0] + p0
    trigger = (p1 + gl[:, 1] > post0) | (p2 + gl[:, 2] > post0)

    def approx2(a, b):
        bigv = np.maximum(a, b)
        smallv = np.minimum(a, b)
        d = bigv - smallv
        i = tables.jacobian_index(d)
        return np.where(np.isinf(smallv) | (d >= tables.JACOBIAN_LOG_MAX_TOLERANCE),
                        bigv, bigv + tables.JACOBIAN_LOG_TABLE[i])

    gt0_lik = approx2(gl[:, 1], gl[:, 2])
    gt0_post = gt0_lik + params.log10_acgt0_prior
    norm_const = approx2(post0, gt0_post)
    norm0 = post0 - norm_const
    prob = np.where(norm0 < params.standard_confidence_for_activity_by_min10,
                    1.0 - np.power(10.0, norm0), 0.0)
    prob = np.where(trigger, prob, 0.0)

    out_idx = upos - low
    valid = (out_idx >= 0) & (out_idx < n)
    is_active[out_idx[valid]] = prob[valid]
    hq_mean[out_idx[valid]] = hq_means[valid]
    return is_active, hq_mean


_NATIVE_ACT_TABLES: list = []


def native_compute_activity(cols: dict, rows: np.ndarray, reference: bytes,
                            low: int, high: int, params: HCParams):
    """Native compute_activity over the ORIGINAL columnar block
    (oracle: compute_activity above; bit-identical, fuzz-tested).
    Returns (is_active, hq_mean) or None to fall back to Python."""
    import os

    if os.environ.get("ELPREP_TPU_NO_NATIVE_ACTIVITY"):
        return None
    from .. import native

    if not _NATIVE_ACT_TABLES:
        _NATIVE_ACT_TABLES.append(dict(
            qual2prob=np.ascontiguousarray(tables.QUAL_TO_PROB_LOG10,
                                           np.float64),
            jac=np.ascontiguousarray(tables.JACOBIAN_LOG_TABLE, np.float64),
            jac_step=float(tables.JACOBIAN_LOG_STEP),
            jac_max_tol=float(tables.JACOBIAN_LOG_MAX_TOLERANCE),
            log10_ploidy=float(LOG10_PLOIDY),
            log10_one_third=float(LOG10_ONE_THIRD),
        ))
    p0, p1, p2 = params.log10_priors
    params_i = dict(
        min_base_qual=int(params.min_base_qual),
        hq_sc_threshold=HIGH_QUALITY_SOFT_CLIP_THRESHOLD,
        max_qual=tables.MAX_QUAL,
        p0=float(p0), p1=float(p1), p2=float(p2),
        acgt0_prior=float(params.log10_acgt0_prior),
        stdconf_min10=float(params.standard_confidence_for_activity_by_min10),
    )
    return native.activity_region(rows, cols, low, high, reference, params_i,
                                  _NATIVE_ACT_TABLES[0])


def make_activity_cols(block) -> dict:
    """Columnar inputs for native_compute_activity from an (original,
    pre-clip) ContigReadBlock."""
    names = block.names if block.names else [b""]
    star = np.array([nm in (b"", b"*") for nm in names], np.uint8)
    return dict(
        flag=np.ascontiguousarray(block.flag, np.int32),
        pos=np.ascontiguousarray(block.pos, np.int64),
        pnext=np.ascontiguousarray(block.pnext, np.int32),
        tlen=np.ascontiguousarray(block.tlen, np.int32),
        cig_off=np.ascontiguousarray(block.cigar_len.offsets, np.int64),
        cig_len=np.ascontiguousarray(block.cigar_len.data, np.int32),
        cig_op=np.ascontiguousarray(block.cigar_op.data, np.uint8),
        seq_data=np.ascontiguousarray(block.seq.data, np.uint8),
        seq_off=np.ascontiguousarray(block.seq.offsets, np.int64),
        qual_data=np.ascontiguousarray(block.qual.data, np.uint8),
        qual_off=np.ascontiguousarray(block.qual.offsets, np.int64),
        rname_star=np.full(len(block),
                           1 if block.contig in (b"", b"*") else 0, np.uint8),
        rnext_star=star[block.rnext_id].astype(np.uint8),
    )


# ---------------------------------------------------------------------------
# State smearing + region decomposition (haplotypecaller.go:286-378)
# ---------------------------------------------------------------------------


def band_pass_states(is_active: np.ndarray, hq_mean: np.ndarray,
                     params: HCParams) -> np.ndarray:
    """processState + bandPassProcessState over all positions.

    Vectorized as one shifted add per kernel offset, iterated from the
    largest offset down: output j then receives its contributions from
    source positions j-50..j+50 in ASCENDING source order — bitwise the
    same accumulation order as the per-hot-position loop
    (`_band_pass_states_py`, the oracle) and the reference's incremental
    smear (haplotypecaller.go:286-299). Adding src==0 terms contributes
    an exact +0.0 (all operands are non-negative), so no masking is
    needed."""
    kernel = tables.GAUSSIAN_KERNEL
    filter_size = len(kernel) // 2
    n = len(is_active)
    states = np.zeros(n, np.float64)
    src = _band_pass_src(is_active, hq_mean, params)
    hot = np.flatnonzero(src > 0)
    if len(hot) * 400 < n:
        # sparse fast path: activity is rare, so scatter each hot
        # position's kernel window instead of 101 full-array passes.
        # Hot positions ascend, so each output still accumulates its
        # contributions in ascending source order — bitwise the same
        # sums as the dense path below (zero sources add exact +0.0).
        for pos in hot:
            band_start = -filter_size if pos - filter_size >= 0 else -pos
            band_end = filter_size if pos + filter_size < n else n - 1 - pos
            states[pos + band_start : pos + band_end + 1] += (
                src[pos]
                * kernel[band_start + filter_size : band_end + filter_size + 1]
            )
        return states
    for k in range(len(kernel) - 1, -1, -1):
        d = k - filter_size
        w = kernel[k]
        if d >= 0:
            if d < n:
                states[d:] += src[: n - d] * w
        else:
            if -d < n:
                states[: n + d] += src[-d:] * w
    return states


def _band_pass_src(is_active, hq_mean, params):
    return np.where(
        (is_active > 0) & (hq_mean > AVERAGE_HQ_SOFT_CLIPS_THRESHOLD),
        is_active * (2 * np.minimum(hq_mean.astype(np.int64),
                                    params.max_prob_propagation_distance) + 1),
        is_active,
    )


def _band_pass_states_py(is_active: np.ndarray, hq_mean: np.ndarray,
                         params: HCParams) -> np.ndarray:
    """Per-hot-position oracle for band_pass_states."""
    kernel = tables.GAUSSIAN_KERNEL
    filter_size = len(kernel) // 2
    n = len(is_active)
    states = np.zeros(n, np.float64)
    src = _band_pass_src(is_active, hq_mean, params)
    hot = np.flatnonzero(src > 0)
    for pos in hot:
        band_start = -filter_size if pos - filter_size >= 0 else -pos
        band_end = filter_size if pos + filter_size < n else n - 1 - pos
        states[pos + band_start : pos + band_end + 1] += (
            src[pos] * kernel[band_start + filter_size : band_end + filter_size + 1]
        )
    return states


@dataclass
class AssemblyRegion:
    contig: str
    reference: bytes
    reads: List[ClipRead] = field(default_factory=list)
    start: int = 0  # 1-based inclusive
    end: int = 0  # inclusive
    extension: int = 0
    contig_length: int = 0
    is_active: bool = False
    supporting_states: Optional[np.ndarray] = None

    def padded_start(self) -> int:
        return max(1, self.start - self.extension)

    def padded_end(self) -> int:
        return min(self.contig_length, self.end + self.extension)

    def reference_bases(self) -> bytes:
        return self.reference[self.padded_start() - 1 : self.padded_end()]


def compute_assembly_regions(contig: str, reference: bytes, region_start: int,
                             region_stop: int, contig_length: int,
                             states: np.ndarray, params: HCParams,
                             keep_states: bool = False,
                             ) -> List[AssemblyRegion]:
    """(reference: computeAssemblyRegions, haplotypecaller.go:328-378).

    The per-position activity scan is replaced by jumps between
    precomputed activity-flip positions; the region loop iterates once
    per emitted region instead of once per reference position.
    `_compute_assembly_regions_py` below is the position-loop oracle."""
    regions: List[AssemblyRegion] = []
    start = region_start
    stop = region_stop
    thr = params.active_prob_threshold
    active = states > thr
    # positions (relative) where activity differs from the previous one
    flips = np.flatnonzero(active[1:] != active[:-1]) + 1
    # region starts advance monotonically, so the next-flip lookup is an
    # advancing pointer, not a per-region binary search (profiled: 40k
    # np.searchsorted wrapper calls cost ~0.9 s of main-thread time at
    # 1M reads — this loop runs between spans on the critical path)
    flips_l = flips.tolist()
    nf = len(flips_l)
    fi = 0
    while stop - start > 0:
        rel = start - region_start
        is_active_region = bool(active[rel])
        max_region_end = start + params.max_region_size
        if stop - start < params.max_region_size:
            max_activity_boundary = stop
        else:
            max_activity_boundary = max_region_end
        while fi < nf and flips_l[fi] <= rel:
            fi += 1
        next_flip = (region_start + flips_l[fi]) if fi < nf else stop
        end_of_active = min(max(next_flip, start + 1), max_activity_boundary)
        if is_active_region and end_of_active == max_region_end:
            min_i = end_of_active - 1
            min_p = float("inf")
            top = min_i
            if top == stop - 1:
                top -= 1
            bottom = start + params.min_region_size - 1
            for i in range(top, bottom - 1, -1):
                cur = states[i - region_start]
                if (cur < min_p and cur <= states[i + 1 - region_start]
                        and cur < states[i - 1 - region_start]):
                    min_i = i
                    min_p = cur
            end_of_active = min_i + 1
        regions.append(AssemblyRegion(
            contig=contig,
            reference=reference,
            start=start + 1,
            end=end_of_active,
            extension=params.padding,
            contig_length=contig_length,
            is_active=is_active_region,
            supporting_states=(states[start - region_start : end_of_active - region_start].copy()
                               if keep_states else None),
        ))
        start = end_of_active
    return regions


def _compute_assembly_regions_py(contig: str, reference: bytes, region_start: int,
                                 region_stop: int, contig_length: int,
                                 states: np.ndarray, params: HCParams,
                                 keep_states: bool = False,
                                 ) -> List[AssemblyRegion]:
    """Position-loop oracle for compute_assembly_regions."""
    regions: List[AssemblyRegion] = []
    start = region_start
    stop = region_stop
    thr = params.active_prob_threshold
    while stop - start > 0:
        is_active_region = states[start - region_start] > thr
        max_region_end = start + params.max_region_size
        if stop - start < params.max_region_size:
            max_activity_boundary = stop
        else:
            max_activity_boundary = max_region_end
        end_of_active = start + 1
        while end_of_active < max_activity_boundary:
            if (states[end_of_active - region_start] > thr) != is_active_region:
                break
            end_of_active += 1
        if is_active_region and end_of_active == max_region_end:
            min_i = end_of_active - 1
            min_p = float("inf")
            top = min_i
            if top == stop - 1:
                top -= 1
            bottom = start + params.min_region_size - 1
            for i in range(top, bottom - 1, -1):
                cur = states[i - region_start]
                if (cur < min_p and cur <= states[i + 1 - region_start]
                        and cur < states[i - 1 - region_start]):
                    min_i = i
                    min_p = cur
            end_of_active = min_i + 1
        regions.append(AssemblyRegion(
            contig=contig,
            reference=reference,
            start=start + 1,
            end=end_of_active,
            extension=params.padding,
            contig_length=contig_length,
            is_active=is_active_region,
            supporting_states=(states[start - region_start : end_of_active - region_start].copy()
                               if keep_states else None),
        ))
        start = end_of_active
    return regions


# ---------------------------------------------------------------------------
# Region finalization (haplotypecaller.go:410-443; haploutils.go:368-430)
# ---------------------------------------------------------------------------


def clean_overlapping_read_pair(r1: ClipRead, r2: ClipRead) -> None:
    """(reference: haploutils.go:390-430)"""
    if r1.rname != r2.rname:
        return
    s1 = soft_start(r1)
    s2 = soft_start(r2)
    if s1 >= s2:
        r1, r2 = r2, r1
    if read_end(r1) < r2.pos:
        return
    read_bases, falls_inside = compute_read_coordinate_for_reference_coordinate(
        r1.cigar, soft_start(r1), r2.pos)
    if read_bases == -1:
        raise ValueError("unexpected coordinate")
    if falls_inside:
        read_bases += 1
    n_overlap = min(len(r1.seq) - read_bases, len(r2.seq))
    if n_overlap > 0:
        q1 = bytearray(r1.qual)
        q2 = bytearray(r2.qual)
        for i2 in range(n_overlap):
            i1 = read_bases + i2
            if r1.seq[i1] == r2.seq[i2]:
                q1[i1] = min(q1[i1], HALF_PCR_SNV_ERROR_QUAL)
                q2[i2] = min(q2[i2], HALF_PCR_SNV_ERROR_QUAL)
            else:
                q1[i1] = 0
                q2[i2] = 0
        r1.qual = bytes(q1)
        r2.qual = bytes(q2)


def for_each_read_pair(reads: List[ClipRead], f: Callable[[ClipRead, ClipRead], None]) -> None:
    """(reference: haploutils.go:368-388)"""
    m = {}
    MULTIPLE, NEXT_UNMAPPED = 0x1, 0x8
    for r2 in reads:
        if (not (r2.flag & MULTIPLE) or (r2.flag & NEXT_UNMAPPED)
                or r2.pnext == 0 or r2.pnext > read_end(r2)):
            continue
        r1 = m.pop(r2.qname, None)
        if r1 is not None:
            f(r1, r2)
        else:
            m[r2.qname] = r2


def finalize_assembly_region(region: AssemblyRegion, params: HCParams,
                             preclip: "dict | None" = None) -> None:
    """(reference: finalizeAssemblyRegion, haplotypecaller.go:410-443)

    ``preclip``: optional id(orig) -> pre-clipped template ClipRead map
    (the region-independent steps — low-qual ends, soft-clip handling,
    adaptor — computed once per worker block by the native clip engine;
    see hc/parallel.py). With it, only the region clip runs here."""
    padded_start = region.padded_start()
    padded_end = region.padded_end()
    kept: List[ClipRead] = []
    for orig in region.reads:
        t = preclip.get(id(orig)) if preclip is not None else None
        if t is not None:
            if len(t.seq) == 0 or read_length_from_cigar(t.cigar) == 0:
                continue
            # fresh mutable copy: hard_clip_to_region and downstream
            # genotyping mutate reads per region
            r = ClipRead(flag=t.flag, pos=t.pos, pnext=t.pnext, tlen=t.tlen,
                         mapq=t.mapq, cigar=list(t.cigar), seq=t.seq,
                         qual=t.qual, rname=t.rname, rnext=t.rnext,
                         qname=t.qname, row=t.row, base_start=t.base_start)
            hard_clip_to_region(r, padded_start, padded_end)
            if read_overlaps_region(r, padded_start, padded_end):
                kept.append(r)
            continue
        r = ClipRead(flag=orig.flag, pos=orig.pos, pnext=orig.pnext,
                     tlen=orig.tlen, mapq=orig.mapq, cigar=list(orig.cigar),
                     seq=orig.seq, qual=orig.qual, rname=orig.rname,
                     rnext=orig.rnext, qname=orig.qname, row=orig.row)
        hard_clip_low_qual_ends(r, params.min_base_qual - 1)
        if params.use_soft_clipped_bases:
            well, _ = has_well_defined_fragment_size(r)
            if well:
                revert_soft_clipped_bases(r)
            else:
                hard_clip_soft_clipped_bases(r)
        else:
            hard_clip_soft_clipped_bases(r)
        if not is_strict_unmapped(r):
            hard_clip_adaptor_sequence(r)
        if len(r.seq) > 0 and read_length_from_cigar(r.cigar) > 0:
            hard_clip_to_region(r, padded_start, padded_end)
            if read_overlaps_region(r, padded_start, padded_end):
                kept.append(r)
    kept.sort(key=_coordinate_sort_key)
    region.reads = kept
    for_each_read_pair(kept, clean_overlapping_read_pair)


def _coordinate_sort_key(r: ClipRead):
    # mirror of CoordinateLess within a single contig (sam-types.go:425-473)
    flag = r.flag
    return (
        r.pos,
        (flag & 0x10) != 0,
        r.qname,
        flag,
        r.mapq,
        r.pnext,
        r.tlen,
    )


def filter_non_passing_reads(region: AssemblyRegion) -> List[ClipRead]:
    """(reference: filterNonPassingReads, haploutils.go:437-455). Returns
    the removed reads (used by the ref-confidence model)."""
    MULTIPLE, NEXT_UNMAPPED = 0x1, 0x8
    removed: List[ClipRead] = []
    kept: List[ClipRead] = []
    for r in region.reads:
        if (len(r.seq) < READ_LENGTH_FILTER_THRESHOLD
                or r.mapq < READ_QUALITY_FILTER_THRESHOLD
                or ((r.flag & MULTIPLE) and not (r.flag & NEXT_UNMAPPED)
                    and r.rnext not in (b"=",) and r.rnext != r.rname)):
            removed.append(r)
        else:
            kept.append(r)
    region.reads = kept
    return removed
