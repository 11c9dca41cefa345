"""Reference confidence model + GVCF block combiner
(reference: filters/ref-confidence.go, filters/variant-combiner.go).

Per-position ref-vs-any genotype likelihoods with indel-informative-read
PLs (ref-confidence.go:112-373), and the strictly ordered GVCF block
combiner with GQ bands, median DP and min PLs (variant-combiner.go:141-263).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io.vcf import Genotype, Variant
from ..filters.clipping import ClipRead, compute_adaptor_boundary
from . import tables
from .activity import (
    READ_LENGTH_FILTER_THRESHOLD,
    READ_QUALITY_FILTER_THRESHOLD,
    AssemblyRegion,
    HCParams,
    filter_non_passing_reads,
    read_end,
)
from .genotyping import (
    LOG10_ONE,
    LOG10_PLOIDY,
    NON_REF,
    _go_round,
    formatf,
)

LOG10_ONE_THIRD = -0.47712125471966244
MAX_INDEL_INFORMATIVE_READS = 40

NO_VARIATION_GT = [0, 0]
NO_VARIATION_FORMAT_GVCF = ["GT", "DP", "GQ", "MIN_DP", "PL"]
NO_VARIATION_FORMAT_NON_GVCF = ["GT", "AD", "DP", "GQ", "PL"]

# IUPAC nucleotide masks (ref-confidence.go:42-81)
_MASKS = {"A": 1, "C": 2, "G": 4, "T": 8}
_IUPAC = {
    "R": 5, "Y": 10, "S": 6, "W": 9, "K": 12, "M": 3,
    "B": 14, "D": 13, "H": 11, "V": 7, "N": 15, "X": 0, "U": 8,
}
BASE_TO_MASK = np.zeros(256, np.int64)
for _c, _m in {**_MASKS, **_IUPAC}.items():
    BASE_TO_MASK[ord(_c)] = _m
    BASE_TO_MASK[ord(_c.lower())] = _m


def _nucleotide_intersect(a: int, b: int) -> bool:
    return (BASE_TO_MASK[a] & BASE_TO_MASK[b]) != 0


# precomputed indel PLs (ref-confidence.go:203-226)
def _make_indel_pls() -> np.ndarray:
    log10_0 = float("-inf")
    log10_1 = 0.0
    log10_2 = math.log10(2)
    denominator = -log10_2
    indel_qual = int(_go_round(-4.5 * -10))
    no_indel = tables.QUAL_TO_PROB_LOG10[indel_qual]
    indel = indel_qual / -10
    pls = np.zeros((MAX_INDEL_INFORMATIVE_READS + 1, 3), np.float64)
    pls[1] = [
        no_indel,
        tables.approximate_log10_sum_log10(no_indel + log10_1, indel + log10_1) + denominator,
        tables.approximate_log10_sum_log10(no_indel + log10_0, indel + log10_2) + denominator,
    ]
    for i in range(2, MAX_INDEL_INFORMATIVE_READS + 1):
        pls[i] = pls[i - 1] + pls[1]
    return pls


INDEL_PLS = _make_indel_pls()


def compute_gq(pls: List[int]) -> int:
    s = sorted(pls)
    return s[1] - s[0]


def _get_gq_log10(likelihoods) -> float:
    qual = likelihoods[0] - max(likelihoods[1], likelihoods[2])
    if qual < 0:
        mx = max(likelihoods)
        normalized = [10 ** (l - mx) for l in likelihoods]
        total = sum(normalized)
        return math.log10(1 - normalized[0] / total)
    return -1 * qual


# ---------------------------------------------------------------------------
# Cursor pileup (pileup.go:58-405) — per-element op context needed here
# ---------------------------------------------------------------------------


@dataclass
class PileupElement:
    read: ClipRead
    base_index: int
    cigar_index: int
    cigar_offset: int

    def op(self) -> Tuple[int, str]:
        return self.read.cigar[self.cigar_index]

    def base(self) -> int:
        return self.read.seq[self.base_index] if 0 <= self.base_index < len(self.read.seq) else 0

    def qual(self) -> int:
        return self.read.qual[self.base_index] if 0 <= self.base_index < len(self.read.qual) else 0

    def next_op(self) -> Optional[Tuple[int, str]]:
        ln, op = self.read.cigar[self.cigar_index]
        if self.cigar_offset + 1 < ln:
            return (ln, op)
        if self.cigar_index + 1 < len(self.read.cigar):
            return self.read.cigar[self.cigar_index + 1]
        return None

    def _advance_to_next_genome_op(self) -> bool:
        cigar = self.read.cigar
        self.cigar_index += 1
        while self.cigar_index < len(cigar):
            ln, op = cigar[self.cigar_index]
            if op in "HP":
                pass
            elif op in "IS":
                self.base_index += ln
            elif op in "DN":
                self.cigar_offset = 0
                return True
            elif op in "M=X":
                self.base_index += 1
                self.cigar_offset = 0
                return True
            else:
                raise ValueError(f"invalid cigar op {op}")
            self.cigar_index += 1
        return False

    def advance(self) -> bool:
        ln, op = self.read.cigar[self.cigar_index]
        self.cigar_offset += 1
        if self.cigar_offset < ln:
            if op in "M=X":
                self.base_index += 1
            return True
        return self._advance_to_next_genome_op()


def _first_element(read: ClipRead) -> Optional[PileupElement]:
    el = PileupElement(read, -1, -1, 0)
    if el._advance_to_next_genome_op():
        return el
    return None


def iter_pileups(reads: List[ClipRead], low: int, high: int,
                 include_empty: bool) -> Iterator[Tuple[int, List[PileupElement]]]:
    """Yield (location, live elements) for positions [low, high)
    (reference: forEachPileup[IncludingEmpty], pileup.go:309-405).
    Reads must be coordinate-sorted; elements stay in read order."""
    if high <= 1 or low >= high:
        return
    elements: List[PileupElement] = []
    pending: List[Tuple[int, PileupElement]] = []
    for read in reads:
        el = _first_element(read)
        if el is None:
            continue
        # advance to >= low
        loc = read.pos
        ok = True
        while loc < low and ok:
            ok = el.advance()
            if ok:
                ln, op = read.cigar[el.cigar_index]
                # reconstruct location: track separately
                loc += 1
        if not ok:
            continue
        pending.append((loc, el))
    pending.sort(key=lambda t: t[0])
    # NB: sort is stable; reads arrive in coordinate order so this keeps
    # the reference's read ordering
    pi = 0
    location = low
    while location < high:
        while pi < len(pending) and pending[pi][0] == location:
            elements.append(pending[pi][1])
            pi += 1
        if elements or include_empty:
            yield location, list(elements)
        location += 1
        if location >= high:
            return
        nxt: List[PileupElement] = []
        for el in elements:
            if el.advance():
                nxt.append(el)
        elements = nxt
        if not elements and not include_empty and pi >= len(pending):
            return


def filter_adaptor_elements(location: int, elements: List[PileupElement]
                            ) -> List[PileupElement]:
    """(reference: pileup.go:252-278)"""
    out = []
    for el in elements:
        r = el.read
        if r.tlen > 100:
            out.append(el)
            continue
        boundary, _, well = compute_adaptor_boundary(r)
        if not well:
            out.append(el)
            continue
        if r.is_reversed():
            if location > boundary:
                out.append(el)
        else:
            if location < boundary:
                out.append(el)
    return out


# ---------------------------------------------------------------------------
# ref-vs-any likelihoods (pileup.go:470-508 with isAltAfterAssembly)
# ---------------------------------------------------------------------------


def _is_alt_after_assembly(el: PileupElement, ref_base: int) -> bool:
    if el.base() != ref_base:
        return True
    if el.op()[1] == "D":
        return True
    return False


@dataclass
class RefConfidence:
    ref_depth: int = 0
    non_ref_depth: int = 0
    gls: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])


def calculate_ref_vs_any(elements: List[PileupElement], ref_base: int,
                         min_base_qual: int) -> RefConfidence:
    rc = RefConfidence()
    read_count = 0.0
    for el in elements:
        if el.op()[1] == "D":
            qual = 30
        else:
            qual = el.qual()
            if qual <= min_base_qual:
                continue
        read_count += 1
        is_alt = _is_alt_after_assembly(el, ref_base)
        ref_lik = tables.QUAL_TO_PROB_LOG10[qual]
        non_ref_lik = qual / -10.0 + LOG10_ONE_THIRD
        if is_alt:
            ref_lik, non_ref_lik = non_ref_lik, ref_lik
            rc.non_ref_depth += 1
        else:
            rc.ref_depth += 1
        rc.gls[0] += ref_lik + LOG10_PLOIDY
        rc.gls[1] += tables.approximate_log10_sum_log10(ref_lik + LOG10_ONE,
                                                        non_ref_lik + LOG10_ONE)
        rc.gls[2] += non_ref_lik + LOG10_PLOIDY
    denominator = read_count * LOG10_PLOIDY
    rc.gls[0] -= denominator
    rc.gls[1] -= denominator
    rc.gls[2] -= denominator
    return rc


# ---------------------------------------------------------------------------
# indel-informative reads (ref-confidence.go:10-200)
# ---------------------------------------------------------------------------

_CONSUMES_REF_OR_S = frozenset("MDN=XS")
_CONSUMES_READ = frozenset("MIS=X")
_CONSUMES_REF = frozenset("MDN=X")


def _bases_and_quals_one_to_one(r: ClipRead) -> Tuple[bytes, bytes]:
    if not any(op in "ID" for _, op in r.cigar):
        return r.seq, r.qual
    out_b = bytearray()
    out_q = bytearray()
    pos = 0
    for ln, op in r.cigar:
        if op in _CONSUMES_READ:
            end = pos + ln
            if op in _CONSUMES_REF:
                out_b += r.seq[pos:end]
                out_q += r.qual[pos:end]
            pos = end
        elif op in _CONSUMES_REF:
            out_b += b"-" * ln
            out_q += b"\x00" * ln
    return bytes(out_b), bytes(out_q)


def _baseline_mismatch_sums(read_bases: bytes, read_quals: bytes, read_start: int,
                            ref: bytes, ref_index: int, padded_end: int) -> np.ndarray:
    n = min(len(read_bases) - read_start, padded_end - ref_index)
    results = np.zeros(n, np.int64)
    total = 0
    for i in range(n - 1, -1, -1):
        rb = read_bases[read_start + i]
        fb = ref[ref_index + i]
        if not _nucleotide_intersect(rb, fb) and rb != ord("-"):
            total += read_quals[read_start + i]
        results[i] = total
    return results


def read_has_no_plausible_indels(cache: Dict[int, np.ndarray], params: HCParams,
                                 r: ClipRead, read_start: int, ref: bytes,
                                 ref_index: int, padded_end: int) -> bool:
    """(reference: readHasNoPlausibleIndelsOfMaxIndelSize,
    ref-confidence.go:137-200, incl. its first-call caching quirk)"""
    key = id(r)
    if key in cache:
        bits = cache[key]
        return bool(bits[read_start]) if read_start < len(bits) else False
    read_length = len(r.seq)
    max_indel = params.indel_size_to_eliminate_in_ref_model

    from .. import native

    if native.available():
        read_bases, read_quals = _bases_and_quals_one_to_one(r)
        bits = native.refconf_informative(
            read_bases, read_quals, read_start, ref, ref_index, padded_end,
            read_length, max_indel, BASE_TO_MASK)
        if bits is not None:
            cache[key] = bits
            return bool(bits[read_start]) if read_start < len(bits) else False

    informative = np.zeros(read_length, bool)
    if read_length - read_start < max_indel or padded_end - ref_index < max_indel:
        cache[key] = informative
        return False
    secondary_break = read_length - max_indel
    read_bases, read_quals = _bases_and_quals_one_to_one(r)
    if len(read_bases) - read_start <= max_indel:
        cache[key] = informative
        return False
    last_relevant = padded_end - ref_index + read_start + 1
    reference_was_shorter = len(read_bases) >= last_relevant
    if not reference_was_shorter:
        last_relevant = len(read_bases) - max_indel
    baseline = _baseline_mismatch_sums(read_bases, read_quals, read_start, ref,
                                       ref_index, padded_end)
    info_big = np.zeros(max(len(read_bases) + 1, read_length), bool)

    def traverse(ins_len: int, del_len: int) -> None:
        global_cost = baseline[0]
        base_qual_sum = 0
        n_direct = min(len(read_bases) - read_start - ins_len,
                       padded_end - ref_index - del_len)
        read_off = n_direct + ins_len - 1
        ref_off = n_direct + del_len - 1
        while read_off >= 0 and ref_off >= 0:
            rb = read_bases[read_start + read_off]
            fb = ref[ref_index + ref_off]
            if not _nucleotide_intersect(rb, fb) and rb != ord("-"):
                base_qual_sum += read_quals[read_start + read_off]
                if base_qual_sum > global_cost:
                    break
            site = min(read_off, ref_off)
            if (read_bases[read_start + site] != ord("-")
                    and read_start + site < last_relevant
                    and read_start + site <= secondary_break
                    and baseline[site] >= base_qual_sum):
                info_big[read_start + site] = True
            read_off -= 1
            ref_off -= 1

    for indel_size in range(1, max_indel + 1):
        traverse(0, indel_size)
        traverse(indel_size, 0)
    if last_relevant <= secondary_break:
        info_big[:last_relevant] = ~info_big[:last_relevant]
        if reference_was_shorter:
            info_big[last_relevant - 1] = False
    else:
        info_big[: secondary_break + 1] = ~info_big[: secondary_break + 1]
    informative = info_big[:max(read_length, 1)]
    cache[key] = informative
    return bool(informative[read_start]) if read_start < len(informative) else False


# ---------------------------------------------------------------------------
# calculateRefConfidence (ref-confidence.go:266-373)
# ---------------------------------------------------------------------------


def _coordinate_sort_key(r: ClipRead):
    flag = r.flag
    return (r.pos, (flag & 0x10) != 0, r.qname, flag, r.mapq, r.pnext, r.tlen)


@dataclass
class SingleVariant:
    """Either a full variant or reduced reference-block info
    (variant-combiner.go:23-36)."""

    full_variant: Optional[Variant] = None
    location: int = 0
    dp: int = 0
    ad: Tuple[int, int] = (0, 0)
    pls: Tuple[int, int, int] = (0, 0, 0)
    gq: int = 0


def reference_variant_to_full(contig: str, reference: bytes, sv: SingleVariant) -> Variant:
    """(reference: fullVariants.addReference, variant-combiner.go:60-84)"""
    ref_byte = reference[sv.location - 1]
    g = Genotype(phased=False, gt=list(NO_VARIATION_GT))
    g.data["AD"] = [sv.ad[0], sv.ad[1]]
    g.data["DP"] = sv.dp
    g.data["GQ"] = sv.gq
    g.data["PL"] = list(sv.pls)
    return Variant(source="HC", chrom=contig, pos=sv.location,
                   ref=chr(ref_byte), alt=[NON_REF],
                   genotype_format=list(NO_VARIATION_FORMAT_NON_GVCF),
                   genotypes=[g])


def calculate_ref_confidence_cursor(params: HCParams, variants: List[SingleVariant],
                             region: AssemblyRegion, reads: List[ClipRead],
                             calls: Optional[List[Variant]],
                             gvcf_mode: bool) -> List[SingleVariant]:
    """(reference: calculateRefConfidence, ref-confidence.go:266-361).
    Appends SingleVariants (full or reduced) to ``variants``."""
    ref = region.reference
    cache: Dict[int, np.ndarray] = {}
    padded_end = region.padded_end()
    reads = sorted(reads, key=_coordinate_sort_key)
    for location, all_elements in iter_pileups(reads, region.start, region.end + 1, True):
        elements = filter_adaptor_elements(location, all_elements)
        overlapping: Optional[Variant] = None
        for vc in calls or []:
            if vc.pos <= location <= vc.end() and (overlapping is None or vc.pos > overlapping.pos):
                overlapping = vc
        if overlapping is not None and overlapping.pos == location:
            variants.append(SingleVariant(full_variant=overlapping))
            continue
        rc = calculate_ref_vs_any(elements, ref[location - 1], 6)
        for i in range(1, 3):
            rc.gls[i] = min(rc.gls[0], rc.gls[i])
        n_informative = 0
        for el in elements:
            ln, op = el.read.cigar[el.cigar_index]
            if op == "D":
                continue
            if el.cigar_offset == ln - 1:
                nxt = el.next_op()
                if nxt is not None and nxt[1] in "DI":
                    continue
            offset = (el.cigar_offset if op in _CONSUMES_REF_OR_S else 0)
            for ln2, op2 in el.read.cigar[: el.cigar_index]:
                if op2 in _CONSUMES_REF_OR_S:
                    offset += ln2
            if read_has_no_plausible_indels(cache, params, el.read, offset, ref,
                                            location - 1, padded_end):
                n_informative += 1
                if n_informative > MAX_INDEL_INFORMATIVE_READS:
                    n_informative = MAX_INDEL_INFORMATIVE_READS
                    break
        indel_gls = INDEL_PLS[n_informative]
        gq_snp = _get_gq_log10(rc.gls)
        gq_indel = _get_gq_log10(indel_gls)
        least = indel_gls if gq_indel > gq_snp else rc.gls
        adjust = max(least[0], least[1], least[2])
        pls = [int(_go_round(min(-10 * (least[i] - adjust), np.iinfo(np.int32).max)))
               for i in range(3)]
        gq = min(compute_gq(list(pls)), 99)
        variants.append(SingleVariant(
            location=location,
            dp=rc.ref_depth + rc.non_ref_depth,
            ad=(rc.ref_depth, rc.non_ref_depth),
            pls=(pls[0], pls[1], pls[2]),
            gq=gq,
        ))
    return variants


def reference_model_for_no_variation(params: HCParams, variants: List[SingleVariant],
                                     region: AssemblyRegion,
                                     gvcf_mode: bool) -> List[SingleVariant]:
    filter_non_passing_reads(region)
    return calculate_ref_confidence(params, variants, region, region.reads, None,
                                    gvcf_mode,
                                    as_runs=params.confidence_mode == "GVCF")


_NATIVE_RC_CTX: list = []


def _native_rc_tables() -> tuple:
    """(params_i, tables_d) singletons for native.refconf_region."""
    if not _NATIVE_RC_CTX:
        params_i = dict(min_read_len=READ_LENGTH_FILTER_THRESHOLD,
                        min_mapq=READ_QUALITY_FILTER_THRESHOLD,
                        max_informative=MAX_INDEL_INFORMATIVE_READS,
                        max_qual=tables.MAX_QUAL, max_indel=0)
        tables_d = dict(
            qual2prob=np.ascontiguousarray(tables.QUAL_TO_PROB_LOG10,
                                           np.float64),
            jac=np.ascontiguousarray(tables.JACOBIAN_LOG_TABLE, np.float64),
            jac_step=float(tables.JACOBIAN_LOG_STEP),
            jac_max_tol=float(tables.JACOBIAN_LOG_MAX_TOLERANCE),
            log10_ploidy=float(LOG10_PLOIDY),
            log10_one_third=float(LOG10_ONE_THIRD),
            indel_gq=np.ascontiguousarray(_indel_gq_log10_table(), np.float64),
            indel_pls=np.ascontiguousarray(_indel_pls_table(), np.int64),
            base_mask=np.ascontiguousarray(BASE_TO_MASK, np.int64),
        )
        _NATIVE_RC_CTX.extend([params_i, tables_d])
    return _NATIVE_RC_CTX[0], _NATIVE_RC_CTX[1]


def native_ref_model_for_no_variation(params: HCParams,
                                      variants: List[SingleVariant],
                                      region: AssemblyRegion,
                                      span_cols: dict, rows: np.ndarray,
                                      reference: bytes):
    """Native one-call replacement for finalize_assembly_region +
    reference_model_for_no_variation on a no-variation region whose
    candidate reads are the block rows ``rows``. Returns the extended
    ``variants`` list, or None to fall back to the Python path (which is
    the oracle; tests fuzz both for bit equality)."""
    if os.environ.get("ELPREP_TPU_NO_NATIVE_REFCONF"):
        return None
    from .. import native

    low, high = region.start, region.end + 1
    if high - low <= 0 or high <= 1:
        return variants  # oracle early-out: no blocks at all
    params_i, tables_d = _native_rc_tables()
    params_i = dict(params_i,
                    max_indel=params.indel_size_to_eliminate_in_ref_model)
    got = native.refconf_region(rows, span_cols, region.padded_start(),
                                region.padded_end(), low, high, reference,
                                params_i, tables_d)
    if got is None:
        return None
    ad_ref, ad_nonref, pls, gq = got
    dp = ad_ref + ad_nonref
    if params.confidence_mode == "GVCF":
        # int32 run payloads: depths/PLs/GQs all fit, and the arrays
        # cross the worker pipes and the main-side concat/vstack —
        # halving the bytes halves that traffic
        variants.append(RefRun(low, dp.astype(np.int32),
                               ad_ref.astype(np.int32),
                               ad_nonref.astype(np.int32),
                               pls.astype(np.int32), gq.astype(np.int32)))
        return variants
    for p in range(high - low):
        variants.append(SingleVariant(
            location=low + p, dp=int(dp[p]),
            ad=(int(ad_ref[p]), int(ad_nonref[p])),
            pls=(int(pls[p, 0]), int(pls[p, 1]), int(pls[p, 2])),
            gq=int(gq[p])))
    return variants


def native_ref_models_batch(params: HCParams, regions, positions, ends,
                            max_ref_len: int, span_cols: dict,
                            reference: bytes):
    """Batched native ref model over a prep task's no-variation regions:
    ONE native call covers row selection + the per-region model
    (native.refconf_regions_batch; per-region oracle is
    native_ref_model_for_no_variation / the Python path). Returns a list
    the same length as ``regions``: each entry is the region's terminal
    variants list, or None when that region must fall back to the
    Python path."""
    n = len(regions)
    outs: list = [None] * n
    if os.environ.get("ELPREP_TPU_NO_NATIVE_REFCONF"):
        return outs
    from .. import native

    metas = []
    idxs = []
    for i, region in enumerate(regions):
        low, high = region.start, region.end + 1
        if high - low <= 0 or high <= 1:
            outs[i] = []  # oracle early-out: no blocks at all
            continue
        metas.append((region.padded_start(), region.padded_end(), low, high))
        idxs.append(i)
    if not metas:
        return outs
    params_i, tables_d = _native_rc_tables()
    params_i = dict(params_i,
                    max_indel=params.indel_size_to_eliminate_in_ref_model)
    metas_a = np.asarray(metas, np.int64)
    sizes = metas_a[:, 3] - metas_a[:, 2]
    out_off = np.concatenate([[0], np.cumsum(sizes)])
    got = native.refconf_regions_batch(metas_a, out_off, positions, ends,
                                       max_ref_len, span_cols, reference,
                                       params_i, tables_d)
    if got is None:
        return outs
    rc, ad_ref, ad_nonref, pls, gq = got
    gvcf = params.confidence_mode == "GVCF"
    for m, i in enumerate(idxs):
        if rc[m] != 0:
            continue  # fall back to the Python path for this region
        lo_, hi_ = int(out_off[m]), int(out_off[m + 1])
        low = int(metas_a[m, 2])
        a_r = ad_ref[lo_:hi_]
        a_n = ad_nonref[lo_:hi_]
        dp = a_r + a_n
        if gvcf:
            outs[i] = [RefRun(low, dp.astype(np.int32),
                              a_r.astype(np.int32), a_n.astype(np.int32),
                              pls[lo_:hi_].astype(np.int32),
                              gq[lo_:hi_].astype(np.int32))]
        else:
            outs[i] = [
                SingleVariant(
                    location=low + p, dp=int(dp[p]),
                    ad=(int(a_r[p]), int(a_n[p])),
                    pls=(int(pls[lo_ + p, 0]), int(pls[lo_ + p, 1]),
                         int(pls[lo_ + p, 2])),
                    gq=int(gq[lo_ + p]))
                for p in range(hi_ - lo_)]
    return outs


# ---------------------------------------------------------------------------
# GVCF variant combiner (variant-combiner.go:105-263)
# ---------------------------------------------------------------------------


def _dp_runs_from_array(a) -> List[List[int]]:
    """Open-block DP multiset as [value, count] runs from a positional
    array (adjacent equal values collapse; order preserved)."""
    vals, counts = _rle_encode(np.asarray(a))
    return [[int(v), int(c)] for v, c in zip(vals.tolist(), counts.tolist())]


def _dp_runs_append(runs: List[List[int]], val: int, count: int = 1) -> None:
    if runs and runs[-1][0] == val:
        runs[-1][1] += count
    else:
        runs.append([val, count])


def _dp_runs_median_min(runs: List[List[int]]) -> Tuple[int, int]:
    """(median, min) of the weighted DP multiset — same semantics as
    sorting the expanded list: odd count takes the middle element, even
    count rounds the two middles half-away-from-zero (go-style)."""
    total = sum(c for _, c in runs)
    lo_idx = (total - 1) // 2
    hi_idx = total // 2
    acc = 0
    lo = hi = 0
    for v, c in sorted(runs):
        if acc <= lo_idx < acc + c:
            lo = v
        if acc <= hi_idx < acc + c:
            hi = v
            break
        acc += c
    if total % 2 == 1:
        med = lo
    else:
        med = int(_go_round((lo + hi) / 2))
    return med, min(v for v, _ in runs)


class VariantCombiner:
    def __init__(self, params: HCParams, get_reference) -> None:
        self.params = params
        self.get_reference = get_reference
        self.contig = ""
        self.ref: bytes = b""
        self.first = True
        self.v_pos = 0
        self.v_end = 0
        self.next_start = -1
        self.v_ref = ""
        # open-block DP multiset as [value, count] runs: a low-coverage
        # open block can span millions of positions (an uncovered contig
        # tail is ONE GQ-0 band), and the per-position int list this
        # replaces dominated merge_run/finalize at that scale
        self.dp_runs: List[List[int]] = []
        self.min_pls = [0, 0, 0]
        self.min_gq = 0
        self.max_gq = 0

    def _find_gq_band(self, gq: int) -> Tuple[int, int]:
        if gq > 99:
            gq = 99
        bands = self.params.gq_bands
        import bisect

        index = bisect.bisect_right(bands, gq)
        return bands[index - 1], bands[index]

    def set_contig(self, variants: List[Variant], contig: str) -> List[Variant]:
        if self.contig == contig:
            return variants
        if not self.first:
            variants.append(self._finalize_block())
        self.contig = contig
        self.ref = self.get_reference(contig)
        self.first = True
        self.next_start = -1
        return variants

    def _init_block(self, sv: SingleVariant) -> None:
        self.v_pos = sv.location
        self.v_end = sv.location
        self.v_ref = chr(self.ref[sv.location - 1])
        self.dp_runs = [[sv.dp, 1]]
        self.min_pls = list(sv.pls)
        self.min_gq, self.max_gq = self._find_gq_band(sv.gq)

    def _finalize_block(self) -> Variant:
        median_dp, min_dp = _dp_runs_median_min(self.dp_runs)
        g = Genotype(phased=False, gt=list(NO_VARIATION_GT))
        g.data["DP"] = median_dp
        g.data["GQ"] = min(compute_gq(list(self.min_pls)), 99)
        g.data["MIN_DP"] = min_dp
        g.data["PL"] = list(self.min_pls)
        v = Variant(chrom=self.contig, pos=self.v_pos, ref=self.v_ref,
                    alt=[NON_REF], genotype_format=list(NO_VARIATION_FORMAT_GVCF),
                    genotypes=[g])
        v.info["END"] = self.v_end
        return v

    def merge_variant(self, variants: List[Variant], sv: SingleVariant) -> List[Variant]:
        if sv.full_variant is not None:
            if not self.first:
                variants.append(self._finalize_block())
                self.first = True
            self.next_start = sv.full_variant.end()
            variants.append(sv.full_variant)
            return variants
        if sv.location <= self.next_start:
            return variants
        if self.first:
            self.first = False
            self._init_block(sv)
            return variants
        if (sv.location == self.v_end + 1 and self.min_gq <= sv.gq < self.max_gq):
            self.v_end = sv.location
            _dp_runs_append(self.dp_runs, sv.dp)
            self.min_pls = [min(a, b) for a, b in zip(self.min_pls, sv.pls)]
            return variants
        variants.append(self._finalize_block())
        self._init_block(sv)
        return variants

    def _emit_block(self, v_pos: int, v_end: int, dp_arr, pls_arr) -> Variant:
        """Finalize a fully-contained block directly from arrays —
        identical output to _finalize_block."""
        dps = np.sort(np.asarray(dp_arr))
        if len(dps) % 2 == 0:
            half = len(dps) // 2
            median_dp = int(_go_round((int(dps[half - 1]) + int(dps[half])) / 2))
        else:
            median_dp = int(dps[(len(dps) + 1) // 2 - 1])
        min_pls = [int(x) for x in np.min(pls_arr, axis=0)]
        g = Genotype(phased=False, gt=list(NO_VARIATION_GT))
        g.data["DP"] = median_dp
        g.data["GQ"] = min(compute_gq(list(min_pls)), 99)
        g.data["MIN_DP"] = int(dps[0])
        g.data["PL"] = min_pls
        v = Variant(chrom=self.contig, pos=v_pos, ref=chr(self.ref[v_pos - 1]),
                    alt=[NON_REF], genotype_format=list(NO_VARIATION_FORMAT_GVCF),
                    genotypes=[g])
        v.info["END"] = v_end
        return v

    def merge_run(self, variants: List[Variant], run) -> List[Variant]:
        return self._merge_run_impl(variants, run, as_batch=True)

    def merge_run_expanded(self, variants: List[Variant], run) -> List[Variant]:
        """merge_run but emitting per-block Variant objects (test oracle
        for the batch form)."""
        return self._merge_run_impl(variants, run, as_batch=False)

    def _merge_run_rle(self, variants, run, as_batch):
        """Run-level merge of an RLE RefRun: identical output to the
        positional paths in _merge_run_impl (which remain the fuzzed
        oracle) but O(joint runs) instead of O(positions) — no
        _rle_decode, no positional band scan, no per-position DP lists.
        Band index depends only on GQ, which is constant within a joint
        run, so every block boundary falls on a run boundary; block
        medians come from a weighted (value, count) median."""
        pos0 = int(run.pos0)
        n = len(run)
        i = 0
        if self.next_start >= pos0:  # skip positions covered by a prior call
            i = min(n, self.next_start - pos0 + 1)
        if i >= n:
            return variants
        counts, gq_v, dp_v, pls_v = run.joint_runs_tail(i)
        gq_v = np.minimum(gq_v, 99)
        dp_v = np.asarray(dp_v, np.int64)
        pos_first = pos0 + i
        m = n - i
        if not self.first:
            if pos_first != self.v_end + 1:
                variants.append(self._finalize_block())
                self.first = True
            else:
                in_band = (gq_v >= self.min_gq) & (gq_v < self.max_gq)
                ext_runs = (len(in_band) if bool(in_band.all())
                            else int(np.argmin(in_band)))
                if ext_runs:
                    ext = int(counts[:ext_runs].sum())
                    self.v_end += ext
                    for k in range(ext_runs):
                        _dp_runs_append(self.dp_runs, int(dp_v[k]),
                                        int(counts[k]))
                    self.min_pls = [min(a, int(b)) for a, b in
                                    zip(self.min_pls,
                                        np.min(pls_v[:ext_runs], axis=0))]
                    if ext >= m:
                        return variants
                    pos_first += ext
                    m -= ext
                    counts = counts[ext_runs:]
                    gq_v = gq_v[ext_runs:]
                    dp_v = dp_v[ext_runs:]
                    pls_v = pls_v[ext_runs:]
                variants.append(self._finalize_block())
                self.first = True
        bands = self.params.gq_bands
        band_idx = np.searchsorted(bands, gq_v, side="right")
        gstarts = np.concatenate(
            [[0], np.flatnonzero(np.diff(band_idx) != 0) + 1]).astype(np.int64)
        open_r = int(gstarts[-1])  # the trailing (open) group's first run
        run_pos = np.concatenate([[0], np.cumsum(counts)])
        if len(gstarts) > 1:
            cs_r = gstarts[:-1]
            ce_r = gstarts[1:]
            sl = slice(0, open_r)
            min_pls_b = np.minimum.reduceat(pls_v[sl], cs_r, axis=0)
            min_dp_b = np.minimum.reduceat(dp_v[sl], cs_r)
            bcounts = run_pos[ce_r] - run_pos[cs_r]
            # weighted per-block median: runs sorted by (block, dp), a
            # global cumulative count, then one searchsorted per middle
            nb = len(cs_r)
            bid = np.repeat(np.arange(nb), ce_r - cs_r)
            order = np.lexsort((dp_v[sl], bid))
            sdp = dp_v[sl][order]
            gcum = np.cumsum(counts[sl][order])
            run0 = np.concatenate([[0], np.cumsum(ce_r - cs_r)[:-1]])
            gb = np.where(run0 > 0, gcum[run0 - 1], 0)
            k_lo = np.searchsorted(gcum, gb + (bcounts - 1) // 2, side="right")
            k_hi = np.searchsorted(gcum, gb + bcounts // 2, side="right")
            lo_ = sdp[k_lo]
            # go-style even-count median: round((a+b)/2) half away from
            # zero == (a+b+1)//2 for the non-negative integer depths
            med = np.where(bcounts % 2 == 1, lo_, (lo_ + sdp[k_hi] + 1) // 2)
            two = np.partition(min_pls_b, 1, axis=1)[:, :2]
            gq_b = np.minimum(two[:, 1] - two[:, 0], 99)
            b_pos = pos_first + run_pos[cs_r].astype(np.int64)
            b_end = b_pos + bcounts.astype(np.int64) - 1
            ref_arr = np.frombuffer(self.ref, np.uint8)
            batch = RefBlockBatch(
                chrom=self.contig, pos=b_pos, end=b_end,
                ref_base=ref_arr[b_pos - 1],
                dp=np.asarray(med, np.int64),
                gq=gq_b.astype(np.int64),
                min_dp=min_dp_b.astype(np.int64),
                pls=min_pls_b.astype(np.int64))
            if as_batch:
                variants.append(batch)
            else:
                variants.extend(batch.expand())
        # trailing band group stays open for the next merge
        self.first = False
        self.v_pos = pos_first + int(run_pos[open_r])
        self.v_end = pos_first + m - 1
        self.v_ref = chr(self.ref[self.v_pos - 1])
        self.dp_runs = []
        for k in range(open_r, len(counts)):
            _dp_runs_append(self.dp_runs, int(dp_v[k]), int(counts[k]))
        self.min_pls = [int(x) for x in np.min(pls_v[open_r:], axis=0)]
        self.min_gq, self.max_gq = self._find_gq_band(int(gq_v[open_r]))
        return variants

    def _merge_run_impl(self, variants, run, as_batch):
        """Vectorized merge of a contiguous reference run: equivalent to
        calling merge_variant per position (variant-combiner.go:141-263),
        but band splits are computed array-wise."""
        if (as_batch and run._rle is not None
                and not os.environ.get("ELPREP_TPU_NO_RLE_COMBINE")):
            # runs that arrived RLE (worker pipes) merge at run level;
            # the positional paths below stay as the oracle (serial HC,
            # merge_run_expanded, and the RLE fuzz test pin equality)
            return self._merge_run_rle(variants, run, as_batch)
        pos0 = int(run.pos0)
        n = len(run)
        i = 0
        if self.next_start >= pos0:  # skip positions covered by a prior call
            i = min(n, self.next_start - pos0 + 1)
        if i >= n:
            return variants
        gq = np.minimum(run.gq[i:], 99)
        dp = run.dp[i:]
        pls = run.pls[i:]
        pos_first = pos0 + i
        m = len(gq)
        j = 0
        if not self.first:
            if pos_first != self.v_end + 1:
                variants.append(self._finalize_block())
                self.first = True
            else:
                in_band = (gq >= self.min_gq) & (gq < self.max_gq)
                ext = m if bool(in_band.all()) else int(np.argmin(in_band))
                if ext:
                    self.v_end += ext
                    for v_, c_ in _dp_runs_from_array(dp[:ext]):
                        _dp_runs_append(self.dp_runs, v_, c_)
                    self.min_pls = [min(a, int(b)) for a, b in
                                    zip(self.min_pls, np.min(pls[:ext], axis=0))]
                j = ext
                if j >= m:
                    return variants
                variants.append(self._finalize_block())
                self.first = True
        bands = self.params.gq_bands
        from .. import native as _native

        got = _native.gvcf_band_blocks(run.gq[i:], dp, pls, j, bands)
        if got is not None:
            # native one-pass block scan (this numpy section, below, is
            # its fuzzed oracle)
            cs, counts, med, min_dp_b, gq_b, min_pls_b, open_a = got
            if len(cs):
                b_pos = pos_first + cs
                b_end = b_pos + counts - 1
                ref_arr = np.frombuffer(self.ref, np.uint8)
                batch = RefBlockBatch(
                    chrom=self.contig, pos=b_pos, end=b_end,
                    ref_base=ref_arr[b_pos - 1],
                    dp=med, gq=gq_b, min_dp=min_dp_b, pls=min_pls_b)
                if as_batch:
                    variants.append(batch)
                else:
                    variants.extend(batch.expand())
            self.first = False
            self.v_pos = pos_first + open_a
            self.v_end = pos_first + m - 1
            self.v_ref = chr(self.ref[self.v_pos - 1])
            self.dp_runs = _dp_runs_from_array(dp[open_a:m])
            self.min_pls = [int(x) for x in np.min(pls[open_a:m], axis=0)]
            self.min_gq, self.max_gq = self._find_gq_band(int(gq[open_a]))
            return variants
        band_idx = np.searchsorted(bands, gq, side="right")
        changes = np.flatnonzero(np.diff(band_idx[j:]) != 0) + 1 + j
        starts = np.concatenate([[j], changes]).astype(np.int64)
        # complete blocks = all band runs except the trailing (open) one
        open_a = int(starts[-1])
        if len(starts) > 1:
            cs = starts[:-1]
            sl = slice(j, open_a)
            min_pls_b = np.minimum.reduceat(pls[sl], cs - j, axis=0)
            min_dp_b = np.minimum.reduceat(dp[sl], cs - j)
            counts = np.diff(np.append(cs, open_a))
            # per-block median DP: sort (block, dp) then index the middles
            bid = np.repeat(np.arange(len(cs)), counts)
            order = np.lexsort((dp[sl], bid))
            dps_sorted = dp[sl][order]
            c0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
            odd = counts % 2 == 1
            mid_lo = c0 + (counts - 1) // 2
            mid_hi = c0 + counts // 2
            # go-style median of an even count: round((a+b)/2) with
            # half-away-from-zero equals (a+b+1)//2 for the non-negative
            # integer depths ((a+b)/2 is exact in float64 below 2^52)
            lo_ = dps_sorted[mid_lo].astype(np.int64)
            med = np.where(odd, lo_, (lo_ + dps_sorted[mid_hi] + 1) // 2)
            two = np.partition(min_pls_b, 1, axis=1)[:, :2]
            gq_b = np.minimum(two[:, 1] - two[:, 0], 99)
            b_pos = pos_first + cs.astype(np.int64)
            b_end = b_pos + counts.astype(np.int64) - 1
            ref_arr = np.frombuffer(self.ref, np.uint8)
            batch = RefBlockBatch(
                chrom=self.contig, pos=b_pos, end=b_end,
                ref_base=ref_arr[b_pos - 1],
                dp=np.asarray(med, np.int64), gq=gq_b.astype(np.int64),
                min_dp=min_dp_b.astype(np.int64),
                pls=min_pls_b.astype(np.int64))
            if as_batch:
                variants.append(batch)
            else:
                variants.extend(batch.expand())
        # trailing band run stays open for the next merge
        self.first = False
        self.v_pos = pos_first + open_a
        self.v_end = pos_first + m - 1
        self.v_ref = chr(self.ref[self.v_pos - 1])
        self.dp_runs = _dp_runs_from_array(dp[open_a:m])
        self.min_pls = [int(x) for x in np.min(pls[open_a:m], axis=0)]
        self.min_gq, self.max_gq = self._find_gq_band(int(gq[open_a]))
        return variants

    def finalize(self) -> Optional[Variant]:
        if self.first:
            return None
        return self._finalize_block()


# ---------------------------------------------------------------------------
# Vectorized ref-confidence (same results as the cursor version; the
# flat-expansion + ordered-reduceat pattern from hc/activity.py)
# ---------------------------------------------------------------------------

_CONSUME_REF_OR_S_LUT = np.zeros(256, np.int64)
for _c in b"MDN=XS":
    _CONSUME_REF_OR_S_LUT[_c] = 1


def _expand_refconf_elements(reads: List[ClipRead], low: int, high: int):
    """Flat (read, refpos) table with refconf-specific fields, sorted by
    (refpos, read order). Vectorized like activity.expand_elements: one
    scalar descriptor per (read, ref-consuming op) segment, then a flat
    numpy expansion; `_expand_refconf_elements_py` below is the oracle."""
    seg_rows: List[tuple] = []
    _SEG_KEYS = ("ridx", "off0", "off1", "loc", "bi", "op", "oplen",
                 "refs_cum", "next_di", "keep_mode", "bound")
    flat_seq_parts: List[bytes] = []
    flat_qual_parts: List[bytes] = []
    seq_off: List[int] = []
    qual_off: List[int] = []
    seq_len: List[int] = []
    qual_len: List[int] = []
    so = qo = 0
    for ridx, r in enumerate(reads):
        if r.pos >= high:
            break
        flat_seq_parts.append(r.seq if len(r.seq) else b"\x00")
        flat_qual_parts.append(r.qual if len(r.qual) else b"\x00")
        seq_off.append(so)
        qual_off.append(qo)
        seq_len.append(len(r.seq))
        qual_len.append(len(r.qual))
        so += max(len(r.seq), 1)
        qo += max(len(r.qual), 1)
        if r.tlen > 100:
            keep_mode, bound = 0, 0
        else:
            boundary, _, well = compute_adaptor_boundary(r)
            if not well:
                keep_mode, bound = 0, 0
            else:
                keep_mode = 1 if r.is_reversed() else 2  # 1: pos>b, 2: pos<b
                bound = boundary
        base_index = 0
        loc = r.pos
        refs_cum = 0
        n_ops = len(r.cigar)
        for ci, (length, op) in enumerate(r.cigar):
            if op in "HP":
                continue
            if op == "I":
                base_index += length
                continue
            if op == "S":
                base_index += length
                refs_cum += length
                continue
            s_ = max(loc, low)
            e_ = min(loc + length, high)
            if e_ > s_:
                seg_rows.append((
                    ridx, s_ - loc, e_ - loc, loc, base_index, ord(op), length,
                    refs_cum,
                    1 if (ci + 1 < n_ops and r.cigar[ci + 1][1] in "DI") else 0,
                    keep_mode, bound))
            loc += length
            refs_cum += length
            if op in "M=X":
                base_index += length

    if not seg_rows:
        return None
    seg_mat = np.array(seg_rows, np.int64)
    sa = {k: seg_mat[:, i] for i, k in enumerate(_SEG_KEYS)}
    lens = sa["off1"] - sa["off0"]
    total = int(lens.sum())
    sid = np.repeat(np.arange(len(lens)), lens)
    cum0 = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(total, dtype=np.int64) - cum0[sid]
    elem_off = sa["off0"][sid] + within
    positions = sa["loc"][sid] + elem_off
    op_c = sa["op"][sid]
    is_match_elem = (op_c == ord("M")) | (op_c == ord("=")) | (op_c == ord("X"))
    is_del_elem = op_c == ord("D")

    ridx_e = sa["ridx"][sid]
    flat_seq = np.frombuffer(b"".join(flat_seq_parts), np.uint8)
    flat_qual = np.frombuffer(b"".join(flat_qual_parts), np.uint8)
    seq_off_a = np.asarray(seq_off, np.int64)
    qual_off_a = np.asarray(qual_off, np.int64)
    seq_len_a = np.asarray(seq_len, np.int64)
    qual_len_a = np.asarray(qual_len, np.int64)

    # D/N elements read the base before the op (clamped at 0)
    bidx = np.where(is_match_elem, sa["bi"][sid] + elem_off,
                    np.maximum(sa["bi"][sid] - 1, 0))
    sl = seq_len_a[ridx_e]
    ql = qual_len_a[ridx_e]
    bases = flat_seq[seq_off_a[ridx_e] + np.clip(bidx, 0, np.maximum(sl - 1, 0))
                     ].astype(np.int64)
    quals = flat_qual[qual_off_a[ridx_e] + np.clip(bidx, 0, np.maximum(ql - 1, 0))
                      ].astype(np.int64)
    bases[sl == 0] = 0
    quals[ql == 0] = 0

    qual_eff = np.where(is_del_elem, 30, quals)
    cand = ~is_del_elem & ~((sa["next_di"][sid] == 1)
                            & (elem_off == sa["oplen"][sid] - 1))
    refs_off = sa["refs_cum"][sid] + elem_off
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
        is_del=is_del_elem[order],
        keep=keep[order],
        cand=cand[order],
        refs_off=refs_off[order],
    )


def _expand_refconf_elements_py(reads: List[ClipRead], low: int, high: int):
    """Per-op loop oracle for the vectorized _expand_refconf_elements."""
    cols = {k: [] for k in ("refpos", "read_idx", "qual", "base", "is_del",
                            "keep", "cand", "refs_off")}
    for ridx, r in enumerate(reads):
        if r.pos >= high:
            break
        if r.tlen > 100:
            keep_rule = None
        else:
            boundary, _, well = compute_adaptor_boundary(r)
            keep_rule = (boundary, r.is_reversed()) if well else None
        base_index = 0
        loc = r.pos
        refs_cum = 0
        n_ops = len(r.cigar)
        for ci, (length, op) in enumerate(r.cigar):
            if op in "HP":
                continue
            if op == "I":
                base_index += length
                continue
            if op == "S":
                base_index += length
                refs_cum += length
                continue
            s_ = max(loc, low)
            e_ = min(loc + length, high)
            if e_ > s_:
                offs = np.arange(s_ - loc, e_ - loc, dtype=np.int64)
                m = len(offs)
                positions = loc + offs
                if op in "M=X":
                    bidx = base_index + offs
                    quals = np.frombuffer(r.qual, np.uint8)[bidx].astype(np.int64)
                    bases = np.frombuffer(r.seq, np.uint8)[bidx].astype(np.int64)
                    is_del = np.zeros(m, bool)
                else:  # D or N
                    safe = max(base_index - 1, 0)
                    qv = r.qual[safe] if len(r.qual) else 0
                    bv = r.seq[safe] if len(r.seq) else 0
                    quals = np.full(m, qv, np.int64)
                    bases = np.full(m, bv, np.int64)
                    is_del = np.full(m, op == "D", bool)
                qual_eff = np.where(is_del, 30, quals)
                # informative candidate: not D; and not (last-of-op with
                # next op D/I) (ref-confidence.go:289-299)
                next_di = False
                if ci + 1 < n_ops and r.cigar[ci + 1][1] in "DI":
                    next_di = True
                cand = ~is_del
                if next_di:
                    cand = cand & (offs != length - 1)
                refs_off = refs_cum + offs
                if keep_rule is None:
                    keep = np.ones(m, bool)
                else:
                    boundary, rev = keep_rule
                    keep = positions > boundary if rev else positions < boundary
                cols["refpos"].append(positions)
                cols["read_idx"].append(np.full(m, ridx, np.int64))
                cols["qual"].append(qual_eff)
                cols["base"].append(bases)
                cols["is_del"].append(is_del)
                cols["keep"].append(keep)
                cols["cand"].append(cand)
                cols["refs_off"].append(refs_off)
            loc += length
            refs_cum += length
            if op in "M=X":
                base_index += length
    if not cols["refpos"]:
        return None
    flat = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((flat["read_idx"], flat["refpos"]))
    return {k: v[order] for k, v in flat.items()}


class RefBlockBatch:
    """Finalized GVCF reference blocks in columnar form.

    Produced by VariantCombiner.merge_run so hundreds of thousands of
    reference-block records never become per-record Variant/Genotype
    Python objects; the VCF writer formats a whole batch at once
    (reference record shape: variant-combiner.go:183-212)."""

    __slots__ = ("chrom", "pos", "end", "ref_base", "dp", "gq", "min_dp", "pls")

    def __init__(self, chrom, pos, end, ref_base, dp, gq, min_dp, pls):
        self.chrom = chrom
        self.pos = pos
        self.end = end
        self.ref_base = ref_base  # uint8 ASCII
        self.dp = dp
        self.gq = gq
        self.min_dp = min_dp
        self.pls = pls  # (n, 3)

    def __len__(self) -> int:
        return len(self.pos)

    def expand(self) -> List[Variant]:
        """Per-block Variant objects (identical to the pre-batch form)."""
        out = []
        for k in range(len(self.pos)):
            g = Genotype(phased=False, gt=list(NO_VARIATION_GT))
            g.data["DP"] = int(self.dp[k])
            g.data["GQ"] = int(self.gq[k])
            g.data["MIN_DP"] = int(self.min_dp[k])
            g.data["PL"] = [int(x) for x in self.pls[k]]
            v = Variant(chrom=self.chrom, pos=int(self.pos[k]),
                        ref=chr(self.ref_base[k]), alt=[NON_REF],
                        genotype_format=list(NO_VARIATION_FORMAT_GVCF),
                        genotypes=[g])
            v.info["END"] = int(self.end[k])
            out.append(v)
        return out

    def format_lines(self) -> str:
        """Vectorized text form — byte-identical to formatting each
        expanded Variant through io.vcf.format_variant's fast path."""
        return self.format_bytes().decode("latin-1")

    def format_bytes(self) -> bytes:
        """Text form as bytes; the hot path is the native one-pass
        formatter (gvcf_format_blocks in elprep_native.cpp)."""
        from .. import native

        fast = native.gvcf_format_blocks(
            self.chrom.encode(), self.ref_base, self.pos, self.end,
            self.dp, self.gq, self.min_dp, self.pls)
        if fast is not None:
            return fast
        c = self.chrom
        rb = self.ref_base.tobytes().decode("latin-1")
        return "".join(
            "%s\t%d\t.\t%s\t<NON_REF>\t.\t.\tEND=%d\tGT:DP:GQ:MIN_DP:PL\t0/0:%d:%d:%d:%d,%d,%d\n"
            % (c, p, rb[k], e, d, q, m, p0, p1, p2)
            for k, (p, e, d, q, m, (p0, p1, p2)) in enumerate(
                zip(self.pos.tolist(), self.end.tolist(), self.dp.tolist(),
                    self.gq.tolist(), self.min_dp.tolist(),
                    self.pls.tolist()))).encode("latin-1")


def expand_variants(variants) -> List[Variant]:
    """Flatten a writer-ready variants list (Variant | RefBlockBatch)
    into per-record Variant objects."""
    out: List[Variant] = []
    for v in variants:
        if isinstance(v, RefBlockBatch):
            out.extend(v.expand())
        else:
            out.append(v)
    return out


def _rle_encode(a: np.ndarray):
    """(values, counts) run-length pair; rows for 2-D arrays."""
    a = np.ascontiguousarray(a)
    n = len(a)
    if n == 0:
        return a, np.zeros(0, np.int32)
    change = np.empty(n, bool)
    change[0] = True
    if a.ndim == 1:
        np.not_equal(a[1:], a[:-1], out=change[1:])
    else:
        np.any(a[1:] != a[:-1], axis=1, out=change[1:])
    idx = np.flatnonzero(change)
    counts = np.diff(np.append(idx, n)).astype(np.int32)
    return a[idx], counts


def _rle_decode(vals: np.ndarray, counts: np.ndarray) -> np.ndarray:
    return np.repeat(vals, counts, axis=0)


class RefRun:
    """A contiguous run of reference-model positions in array form.

    Produced by calculate_ref_confidence(as_runs=True) so the GVCF
    combiner can band-split whole runs vectorized instead of merging
    2M single positions through Python objects
    (reference: variant-combiner.go:141-263).

    Pickling run-length encodes every column: the per-position arrays
    are piecewise constant over band-sized stretches, so the worker
    pool's result queue moves ~10-30x fewer bytes per contig span
    (measured ~420 MB of raw int32 pickles at 1M reads / 15 Mb) while
    the decoded arrays are bit-identical. A run that arrives RLE (from
    a worker pipe) STAYS RLE: the combiner's run-level band scan
    (_merge_run_rle) never rebuilds the positional arrays, and the
    column properties decode lazily only for consumers that index
    positions (tests, the oracle merge path)."""

    __slots__ = ("pos0", "_cols", "_rle", "_n")

    _KEYS = ("dp", "ad_ref", "ad_nonref", "pls", "gq")

    def __init__(self, pos0, dp, ad_ref, ad_nonref, pls, gq):
        self.pos0 = pos0
        self._cols = {"dp": dp, "ad_ref": ad_ref, "ad_nonref": ad_nonref,
                      "pls": pls, "gq": gq}
        self._rle = None
        self._n = len(gq)

    @classmethod
    def from_rle(cls, pos0, rle: dict, n: int) -> "RefRun":
        self = cls.__new__(cls)
        self.pos0 = pos0
        self._cols = {}
        self._rle = rle
        self._n = n
        return self

    def _col(self, k: str):
        v = self._cols.get(k)
        if v is None:
            vals, counts = self._rle[k]
            v = self._cols[k] = _rle_decode(vals, counts)
        return v

    dp = property(lambda self: self._col("dp"))
    ad_ref = property(lambda self: self._col("ad_ref"))
    ad_nonref = property(lambda self: self._col("ad_nonref"))
    pls = property(lambda self: self._col("pls"))
    gq = property(lambda self: self._col("gq"))

    @property
    def full_variant(self):  # duck-typing parity with SingleVariant
        return None

    def __len__(self) -> int:
        return self._n

    def __getstate__(self):
        r = self.rle()
        return (self.pos0, self._n) + tuple(r[k] for k in self._KEYS)

    def __setstate__(self, state):
        self.pos0 = state[0]
        self._n = state[1]
        self._cols = {}
        self._rle = dict(zip(self._KEYS, state[2:]))

    def rle(self) -> dict:
        if self._rle is None:
            self._rle = {k: _rle_encode(np.ascontiguousarray(self._cols[k]))
                         for k in self._KEYS}
        return self._rle

    def joint_runs_tail(self, i: int):
        """(counts, gq_v, dp_v, pls_v) of the joint (gq, dp, pls) runs
        covering positions [i, n): boundaries are the union of the three
        columns' run boundaries, so every returned run is constant in
        all three columns (runs need not be maximal)."""
        r = self.rle()
        gv, gc = r["gq"]
        dv, dc = r["dp"]
        pv, pc = r["pls"]
        ge = np.cumsum(gc.astype(np.int64))
        de = np.cumsum(dc.astype(np.int64))
        pe = np.cumsum(pc.astype(np.int64))
        ends = np.unique(np.concatenate([ge, de, pe]))
        ends = ends[ends > i]
        starts = np.concatenate([[i], ends[:-1]])
        counts = ends - starts
        gq_v = gv[np.searchsorted(ge, starts, side="right")]
        dp_v = dv[np.searchsorted(de, starts, side="right")]
        pls_v = pv[np.searchsorted(pe, starts, side="right")]
        return counts, gq_v, dp_v, pls_v


def concat_ref_runs(runs: "List[RefRun]") -> "RefRun":
    """Concatenate position-adjacent runs (runs[k+1].pos0 must equal
    runs[k].pos0 + len(runs[k])) into one run. merge_run over the result
    is equivalent to merging each run in sequence — band splits depend
    only on per-position GQ and adjacency, both preserved — so the
    driver batches adjacent runs to amortize the per-call numpy cost.
    RLE runs (the pooled path) concatenate at the run level without
    decoding; the result's runs are simply not maximal across the seams,
    which no consumer requires."""
    if len(runs) == 1:
        return runs[0]
    if all(r._rle is not None for r in runs):
        rle = {k: (np.concatenate([r._rle[k][0] for r in runs]),
                   np.concatenate([r._rle[k][1] for r in runs]))
               for k in RefRun._KEYS}
        return RefRun.from_rle(runs[0].pos0, rle,
                               sum(r._n for r in runs))
    return RefRun(
        runs[0].pos0,
        np.concatenate([r.dp for r in runs]),
        np.concatenate([r.ad_ref for r in runs]),
        np.concatenate([r.ad_nonref for r in runs]),
        np.vstack([r.pls for r in runs]),
        np.concatenate([r.gq for r in runs]),
    )


def gq_log10(g: np.ndarray) -> np.ndarray:
    """Vectorized GQ in log10 space over [N,3] genotype likelihoods
    (ref-confidence.go gq helper semantics)."""
    qual = g[:, 0] - np.maximum(g[:, 1], g[:, 2])
    mx = np.max(g, axis=1, keepdims=True)
    norm = 10.0 ** (g - mx)
    total = np.sum(norm, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        alt_val = np.log10(1 - norm[:, 0] / total)
    return np.where(qual < 0, alt_val, -qual)


_IND_TABLES: list = []


def _indel_gq_log10_table() -> np.ndarray:
    if not _IND_TABLES:
        gq_t = gq_log10(INDEL_PLS)
        adjust = np.max(INDEL_PLS, axis=1, keepdims=True)
        pls_t = np.floor(np.minimum(-10 * (INDEL_PLS - adjust),
                                    np.iinfo(np.int32).max) + 0.5).astype(np.int64)
        _IND_TABLES.extend([gq_t, pls_t])
    return _IND_TABLES[0]


def _indel_pls_table() -> np.ndarray:
    _indel_gq_log10_table()
    return _IND_TABLES[1]


def calculate_ref_confidence(params: HCParams, variants: List[SingleVariant],
                             region: AssemblyRegion, reads: List[ClipRead],
                             calls: Optional[List[Variant]],
                             gvcf_mode: bool,
                             as_runs: bool = False) -> List[SingleVariant]:
    """Vectorized calculateRefConfidence (ref-confidence.go:266-361)."""
    ref = region.reference
    padded_end = region.padded_end()
    reads = sorted(reads, key=_coordinate_sort_key)
    low, high = region.start, region.end + 1
    n_pos = high - low
    if n_pos <= 0 or high <= 1:
        return variants

    el = _expand_refconf_elements(reads, low, high)

    # per-position overlapping call: the max-pos overlapping call
    # substitutes the ref model only when its Pos equals the location
    # (ref-confidence.go:272-283); other covered positions still get
    # the reference model
    call_at = np.full(n_pos, -1, np.int64)
    for k, vc in enumerate(calls or []):
        a = max(vc.pos, low) - low
        b = min(vc.end(), high - 1) - low
        if b >= a:
            call_at[a : b + 1] = k  # later calls have larger pos: max-pos wins
    if calls:
        call_pos = np.fromiter((c.pos for c in calls), np.int64, len(calls))
        exact_sub = np.where(
            (call_at >= 0)
            & (call_pos[np.maximum(call_at, 0)] - low
               == np.arange(n_pos, dtype=np.int64)),
            call_at, -1)
    else:
        exact_sub = np.full(n_pos, -1, np.int64)

    dp_arr = np.zeros(n_pos, np.int64)
    ref_depth = np.zeros(n_pos, np.int64)
    nonref_depth = np.zeros(n_pos, np.int64)
    gl0 = np.zeros(n_pos, np.float64)
    gl1 = np.zeros(n_pos, np.float64)
    gl2 = np.zeros(n_pos, np.float64)
    n_inf = np.zeros(n_pos, np.int64)

    if el is not None and len(el["refpos"]):
        keep = el["keep"]
        for k in list(el):
            el[k] = el[k][keep]
        refpos = el["refpos"]
        if len(refpos):
            # qual gate (6) except deletions
            usable = el["is_del"] | (el["qual"] > 6)
            upos_idx = refpos - low
            ref_arr = np.frombuffer(ref, np.uint8)
            ref_base = ref_arr[np.clip(refpos - 1, 0, len(ref_arr) - 1)].astype(np.int64)
            is_alt = (el["base"] != ref_base) | el["is_del"]

            qual_c = np.clip(el["qual"], 0, tables.MAX_QUAL)
            ref_lik = tables.QUAL_TO_PROB_LOG10[qual_c]
            nonref_lik = el["qual"].astype(np.float64) / -10.0 + LOG10_ONE_THIRD
            rl = np.where(is_alt, nonref_lik, ref_lik)
            nl = np.where(is_alt, ref_lik, nonref_lik)
            t0 = rl + LOG10_PLOIDY
            big = np.maximum(rl, nl)
            small = np.minimum(rl, nl)
            diff = big - small
            jidx = tables.jacobian_index(diff)
            t1 = np.where(np.isinf(small) | (diff >= tables.JACOBIAN_LOG_MAX_TOLERANCE),
                          big, big + tables.JACOBIAN_LOG_TABLE[jidx])
            t2 = nl + LOG10_PLOIDY

            um = usable
            sel_pos = upos_idx[um]
            # ordered segment sums (rows pre-sorted by (refpos, read order))
            if len(sel_pos):
                # sel_pos is sorted: diff-based uniques beat np.unique
                starts = np.concatenate(
                    [[0], np.flatnonzero(np.diff(sel_pos)) + 1])
                uvals = sel_pos[starts]
                gl0[uvals] = np.add.reduceat(t0[um], starts)
                gl1[uvals] = np.add.reduceat(t1[um], starts)
                gl2[uvals] = np.add.reduceat(t2[um], starts)
                counts = np.diff(np.append(starts, len(sel_pos)))
                denom = counts.astype(np.float64) * LOG10_PLOIDY
                gl0[uvals] -= denom
                gl1[uvals] -= denom
                gl2[uvals] -= denom
                ref_depth[:] = np.bincount(sel_pos[~is_alt[um]], minlength=n_pos)
                nonref_depth[:] = np.bincount(sel_pos[is_alt[um]], minlength=n_pos)

            # indel-informative reads: per read the informativeness array
            # is computed once with its first candidate offset
            # (reproducing the reference's first-call caching,
            # ref-confidence.go:137-141)
            cache: Dict[int, np.ndarray] = {}
            cm = el["cand"]
            cand_read = el["read_idx"][cm]
            cand_off = el["refs_off"][cm]
            cand_pos = upos_idx[cm]
            informative = np.zeros(len(cand_read), bool)
            if len(cand_read):
                # group candidates per read with ONE stable sort (a
                # boolean mask per unique read is O(reads x candidates));
                # stability keeps each read's first candidate first, so
                # the first-offset cache quirk below is preserved
                order = np.argsort(cand_read, kind="stable")
                co_read = cand_read[order]
                co_off = cand_off[order]
                co_refpos = refpos[cm][order]
                run_starts = np.concatenate(
                    [[0], np.flatnonzero(np.diff(co_read)) + 1])
                run_ends = np.append(run_starts[1:], len(co_read))
                for a, b in zip(run_starts, run_ends):
                    ridx = int(co_read[a])
                    offs = co_off[a:b]
                    r = reads[ridx]
                    # populate the per-read informative bits with the
                    # first element's offset (cache quirk)
                    read_has_no_plausible_indels(cache, params, r,
                                                 int(offs[0]), ref,
                                                 int(co_refpos[a]) - 1,
                                                 padded_end)
                    bits = cache[id(r)]
                    ok = offs < len(bits)
                    vals = np.zeros(len(offs), bool)
                    vals[ok] = bits[offs[ok]]
                    informative[order[a:b]] = vals
                n_inf[:] = np.minimum(
                    np.bincount(cand_pos[informative], minlength=n_pos), 
                    MAX_INDEL_INFORMATIVE_READS)

    # assemble per-position outputs; the indel model depends only on
    # n_inf (<= 40), so its gq/PL values come from precomputed tables
    gls3 = np.stack([gl0, np.minimum(gl0, gl1), np.minimum(gl0, gl2)], axis=1)
    gq_snp = gq_log10(gls3)
    gq_ind = _indel_gq_log10_table()[n_inf]
    use_indel = gq_ind > gq_snp
    adjust = np.max(gls3, axis=1, keepdims=True)
    pls_snp = np.floor(np.minimum(-10 * (gls3 - adjust),
                                  np.iinfo(np.int32).max) + 0.5).astype(np.int64)
    pls = np.where(use_indel[:, None], _indel_pls_table()[n_inf], pls_snp)
    # 3-column second-smallest minus smallest without a full sort
    m0 = np.min(pls, axis=1)
    m2 = np.max(pls, axis=1)
    m1 = pls[:, 0] + pls[:, 1] + pls[:, 2] - m0 - m2
    gq = np.minimum(m1 - m0, 99)

    dp_arr = ref_depth + nonref_depth
    if as_runs:
        subs = np.flatnonzero(exact_sub >= 0)
        seg_start = 0
        def emit_run(a: int, b: int) -> None:
            if b > a:
                variants.append(RefRun(
                    low + a, dp_arr[a:b].astype(np.int32),
                    ref_depth[a:b].astype(np.int32),
                    nonref_depth[a:b].astype(np.int32),
                    pls[a:b].astype(np.int32), gq[a:b].astype(np.int32)))
        for p in subs:
            p = int(p)
            emit_run(seg_start, p)
            variants.append(SingleVariant(full_variant=calls[exact_sub[p]]))
            seg_start = p + 1
        emit_run(seg_start, n_pos)
        return variants
    for p in range(n_pos):
        k = exact_sub[p]
        if k >= 0:
            variants.append(SingleVariant(full_variant=calls[k]))
            continue
        variants.append(SingleVariant(
            location=low + p,
            dp=int(dp_arr[p]),
            ad=(int(ref_depth[p]), int(nonref_depth[p])),
            pls=(int(pls[p, 0]), int(pls[p, 1]), int(pls[p, 2])),
            gq=int(gq[p]),
        ))
    return variants
