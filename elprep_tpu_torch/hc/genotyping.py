"""Genotype assignment, annotations, and phasing
(reference: filters/assigngls.go, filters/realign.go).

Covers: per-haplotype event maps (makeEventMap :88-195), merged variant
construction per start position (:1954-1998), allele mapping and
marginalized read×allele likelihoods (:376-464), diploid GLs
(:2102-2145), allele-frequency EM + genotype assignment
(calculateGenotypes :881-1037), ExcessHet exact test (:1102-1176),
annotations (DP/MQ/FS/SOR/QD/RankSums via Mann-Whitney U, hypergeometric
Fisher, :1253-1748), physical phasing (PGT/PID/PS :1760-1924), and read
realignment to the best haplotype (realign.go:268-396).

All accumulation loops keep the reference's sequential evaluation order
for float64 reproducibility; these run per assembly region on the host
(region read counts are small), downstream of the batched device
PairHMM.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.vcf import Genotype, Variant
from .. import trace
from ..ops import sw
from ..filters.clipping import (
    RIGHT,
    ClipRead,
    get_read_coordinate_for_reference_coordinate,
    is_inside_deletion,
    reference_length_from_cigar,
    soft_end,
    soft_start,
)
from . import tables
from .activity import HCParams, log10_one_minus_pow10, read_end
from .assembly import Haplotype

LOG10_ONE = 0.0
LOG10_PLOIDY = 0.3010299956639812
LOG10_INFORMATIVE_THRESHOLD = 0.2
NON_REF = "<NON_REF>"
MAX_ACCEPTABLE_ALLELE_COUNT = 44
MAX_GENOTYPE_QUAL = 99
NO_VARIATION_GT = [0, 0]
NO_CALL_GT = [-1, -1]

_SIMPLE_BASES = frozenset(b"ACGT")
_SINGLE_ALLELES = {ord(c): c for c in "ACGTN"}


def formatf(value: float, precision: int) -> str:
    """Go strconv.FormatFloat(v, 'f', p, 64) (filters/unpedantic.go:38-41);
    Java-style rounding in pedantic mode (filters/pedantic.go:66-110)."""
    from .. import pedantic

    if pedantic.enabled:
        return pedantic.pedantic_formatf(value, precision)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return "%.*f" % (precision, value)


def log10_sum_log10(a: float, b: float) -> float:
    # exact Go operation order (assigngls.go:633-638); -inf/-inf -> NaN
    if a > b:
        return a + math.log10(1 + 10 ** (b - a))
    return b + math.log10(1 + 10 ** (a - b))


def log10_sum_log10_slice(values: List[float]) -> float:
    if not values:
        return float("-inf")
    max_value = values[0]
    max_index = 0
    for i in range(1, len(values)):
        if values[i] > max_value:
            max_value = values[i]
            max_index = i
    if math.isinf(max_value) and max_value < 0:
        return max_value
    s = 1.0
    for i, v in enumerate(values):
        if i == max_index or (math.isinf(v) and v < 0):
            continue
        s += 10 ** (v - max_value)
    return max_value + math.log10(s)


def is_symbolic_allele(a: str) -> bool:
    if len(a) <= 1:
        return False
    if a[0] in "<." or a[-1] in ">.":
        return True
    return "[" in a or "]" in a


def variant_size(vc: Variant) -> int:
    return vc.end() - vc.pos + 1


# ---------------------------------------------------------------------------
# Event maps (assigngls.go:21-195)
# ---------------------------------------------------------------------------


def _make_block(vc1: Variant, vc2: Variant) -> None:
    if len(vc1.ref) == 1 and len(vc1.alt[0]) == 1:
        if vc1.ref == vc2.ref:
            vc1.alt[0] += vc2.alt[0][1:]
        else:
            vc1.ref = vc2.ref
            _set_end(vc1, vc2.end())
    else:
        if len(vc1.ref) == 1 and len(vc1.alt[0]) > 1 and vc1.ref[0] == vc1.alt[0][0]:
            insertion, deletion = vc1, vc2
        else:
            insertion, deletion = vc2, vc1
        vc1.ref = deletion.ref
        vc1.alt[0] = insertion.alt[0]
        _set_end(vc1, deletion.end())


def _set_end(vc: Variant, value: int) -> None:
    if value == vc.pos - 1 + len(vc.ref):
        vc.info.pop("END", None)
    else:
        vc.info["END"] = value


def _add_event(m: List[Variant], vc: Variant) -> List[Variant]:
    import bisect

    idx = bisect.bisect_left([e.pos for e in m], vc.pos)
    if idx < len(m) and m[idx].pos == vc.pos:
        _make_block(m[idx], vc)
        return m
    m.insert(idx, vc)
    return m


def make_event_map(source: str, contig: str, h: Haplotype, ref: bytes) -> List[Variant]:
    """(reference: makeEventMap, assigngls.go:88-195)"""
    result: List[Variant] = []
    ref_pos = h.location
    if ref_pos < 1:
        return result
    alignment = h.bases
    alignment_pos = 0
    for cigar_index, (length, op) in enumerate(h.cigar):
        if op == "I":
            if ref_pos > 1:
                ref_byte = ref[ref_pos - 2]
                if ref_byte in _SINGLE_ALLELES and 0 < cigar_index < len(h.cigar) - 1:
                    ins = alignment[alignment_pos : alignment_pos + length]
                    if all(b in _SIMPLE_BASES for b in ins):
                        ref_allele = _SINGLE_ALLELES[ref_byte]
                        vc = Variant(source=source, chrom=contig, pos=ref_pos - 1,
                                     ref=ref_allele,
                                     alt=[ref_allele + ins.decode()])
                        result = _add_event(result, vc)
            alignment_pos += length
        elif op == "S":
            alignment_pos += length
        elif op == "D":
            if ref_pos > 1:
                ref_byte = ref[ref_pos - 2]
                if ref_byte in _SINGLE_ALLELES:
                    deletion_bases = ref[ref_pos - 2 : ref_pos - 1 + length]
                    if all(b in _SIMPLE_BASES for b in deletion_bases):
                        ref_allele = _SINGLE_ALLELES[ref_byte]
                        vc = Variant(source=source, chrom=contig, pos=ref_pos - 1,
                                     ref=deletion_bases.decode(),
                                     alt=[ref_allele])
                        _set_end(vc, ref_pos - 1 + length)
                        result = _add_event(result, vc)
            ref_pos += length
        elif op in "M=X":
            for offset in range(length):
                ref_byte = ref[ref_pos - 1 + offset]
                alt_byte = alignment[alignment_pos + offset]
                if ref_byte != alt_byte and ref_byte in _SIMPLE_BASES and alt_byte in _SIMPLE_BASES:
                    vc = Variant(source=source, chrom=contig, pos=ref_pos + offset,
                                 ref=_SINGLE_ALLELES[ref_byte],
                                 alt=[_SINGLE_ALLELES[alt_byte]])
                    result = _add_event(result, vc)
            ref_pos += length
            alignment_pos += length
    return result


def get_overlapping_events(loc: int, haplotypes: List[Haplotype]) -> Dict[int, List[Variant]]:
    out: Dict[int, List[Variant]] = {}
    for i, h in enumerate(haplotypes):
        out[i] = [v for v in (h.events or []) if v.pos <= loc <= v.end()]
    return out


SPAN_DEL = "*"


def compute_active_variant_contexts(loc: int, haplotypes: List[Haplotype],
                                    overlaps: Dict[int, List[Variant]],
                                    ref: bytes) -> List[Variant]:
    """(reference: assigngls.go:228-253)"""
    seen = set()
    ref_allele = _SINGLE_ALLELES.get(ref[loc - 1], "N")
    replacement: Optional[Variant] = None
    result: List[Variant] = []
    for i, _h in enumerate(haplotypes):
        for variant in overlaps[i]:
            key = (variant.pos, variant.ref, ",".join(variant.alt))
            if key in seen:
                continue
            seen.add(key)
            if variant.pos != loc:
                if replacement is None:
                    replacement = Variant(chrom=variant.chrom, pos=loc,
                                          ref=ref_allele, alt=[SPAN_DEL])
                    _set_end(replacement, loc)
                variant = replacement
            result.append(variant)
    return result


def sort_by_sources(events: List[Variant]) -> None:
    sources: List[str] = []
    for e in events:
        if e.source not in sources:
            sources.append(e.source)
    order = {s: i for i, s in enumerate(sources)}
    events.sort(key=lambda e: order[e.source])


def make_merged_variant(events: List[Variant]) -> Variant:
    """(reference: makeMergedVariant, assigngls.go:1954-1998)"""
    sort_by_sources(events)
    first = events[0]
    ref_allele = first.ref
    for e in events[1:]:
        if len(e.ref) > len(ref_allele):
            ref_allele = e.ref
    alt_alleles: List[str] = []
    longest = first
    longest_size = variant_size(longest)
    for vc in events:
        if variant_size(vc) > longest_size:
            longest = vc
            longest_size = variant_size(vc)
        if ref_allele == vc.ref:
            for a in vc.alt:
                if a not in alt_alleles:
                    alt_alleles.append(a)
        else:
            extra = ref_allele[len(vc.ref):]
            for a in vc.alt:
                if a == SPAN_DEL:
                    if a not in alt_alleles:
                        alt_alleles.append(a)
                elif not is_symbolic_allele(a):
                    ae = a + extra
                    if ae not in alt_alleles:
                        alt_alleles.append(ae)
    merged = Variant(source=first.source, chrom=longest.chrom, pos=longest.pos,
                     id=["."], ref=ref_allele, alt=alt_alleles)
    _set_end(merged, longest.end())
    return merged


# ---------------------------------------------------------------------------
# Allele mapping + marginalization (assigngls.go:310-464, 2000-2100)
# ---------------------------------------------------------------------------


class AlleleMap:
    def __init__(self, ref_allele: str) -> None:
        self.alleles: List[str] = [ref_allele]
        self.haplotypes: Dict[str, List[int]] = {ref_allele: []}

    def add_allele(self, allele: str) -> None:
        self.alleles.append(allele)
        self.haplotypes[allele] = []

    def maybe_add(self, allele: str, h: int) -> None:
        if allele in self.haplotypes:
            self.haplotypes[allele].append(h)

    def add(self, allele: str, h: int) -> None:
        if allele in self.haplotypes:
            self.haplotypes[allele].append(h)
        else:
            self.alleles.append(allele)
            self.haplotypes[allele] = [h]

    def remove(self, allele: str) -> None:
        if allele in self.alleles:
            self.alleles.remove(allele)
        self.haplotypes.pop(allele, None)


def create_allele_mapper(variant: Variant, haplotypes: List[Haplotype],
                         overlaps: Dict[int, List[Variant]], loc: int) -> AlleleMap:
    """(reference: createAlleleMapper, assigngls.go:2000-2029)"""
    v_ref = variant.ref
    m = AlleleMap(v_ref)
    for a in variant.alt:
        if not is_symbolic_allele(a):
            m.add_allele(a)
    for i, _h in enumerate(haplotypes):
        spanning = overlaps[i]
        if not spanning:
            m.haplotypes[v_ref].append(i)
            continue
        for ev in spanning:
            if ev.pos == loc:
                first_alt = ev.alt[0]
                if first_alt == SPAN_DEL:
                    m.maybe_add(SPAN_DEL, i)
                else:
                    m.maybe_add(first_alt + v_ref[len(ev.ref):], i)
            else:
                m.add(SPAN_DEL, i)
                break
    return m


def reduce_alt_alleles(variant: Variant, mapper: AlleleMap,
                       haplotypes: List[Haplotype]) -> None:
    """(reference: reduceAltAlleles, assigngls.go:2030-2100)"""
    scored = []
    for idx, allele in enumerate(mapper.alleles):
        best = float("-inf")
        second = float("-inf")
        for h in mapper.haplotypes[allele]:
            s = haplotypes[h].score
            if s > best:
                best, second = s, best
            elif s > second:
                second = s
        scored.append((allele, idx == 0, best, second))
    scored.sort(key=lambda t: (
        not t[1],               # ref first
        -t[2] if not math.isnan(t[2]) else float("inf"),
        -t[3] if not math.isnan(t[3]) else float("inf"),
        t[0],
    ))
    to_remove = {t[0] for t in scored[MAX_ACCEPTABLE_ALLELE_COUNT:]}
    for a in to_remove:
        mapper.remove(a)
    variant.alt = [a for a in variant.alt if a not in to_remove]


@dataclass
class ReadLikelihoods:
    haps: List[Haplotype]
    alns: List[ClipRead]
    values: np.ndarray  # [n_haps, n_reads] float64


@dataclass
class ReadAlleleLikelihoods:
    alleles: List[str]
    alns: List[ClipRead]
    values: Dict[str, List[float]]


def marginalize(likelihoods: ReadLikelihoods, mapper: AlleleMap,
                start: int, stop: int) -> ReadAlleleLikelihoods:
    """(reference: marginalize, assigngls.go:376-414)"""
    reads_to_keep: List[int] = []
    alns: List[ClipRead] = []
    for r, aln in enumerate(likelihoods.alns):
        rstart, rend = aln.pos, read_end(aln)
        if (rstart <= start <= rend) or (rstart <= stop <= rend) or (rstart >= start and rend <= stop):
            reads_to_keep.append(r)
            alns.append(aln)
    values: Dict[str, List[float]] = {}
    for allele in mapper.alleles:
        new_values = [float("-inf")] * len(reads_to_keep)
        for h in mapper.haplotypes[allele]:
            old = likelihoods.values[h]
            for new_index, old_index in enumerate(reads_to_keep):
                v = old[old_index]
                if v > new_values[new_index]:
                    new_values[new_index] = v
        values[allele] = new_values
    return ReadAlleleLikelihoods(alleles=list(mapper.alleles), alns=alns, values=values)


def update_non_ref(likelihoods: ReadAlleleLikelihoods, ref_allele: str,
                   alt_alleles: List[str]) -> None:
    """(reference: updateNonRef, assigngls.go:416-464)"""
    non_ref_index = len(alt_alleles) - 1
    if NON_REF in likelihoods.values:
        non_ref_liks = likelihoods.values[NON_REF]
    else:
        non_ref_liks = [float("-inf")] * len(likelihoods.alns)
        likelihoods.values[NON_REF] = non_ref_liks
    for r in range(len(likelihoods.alns)):
        best = float("-inf")
        for allele in likelihoods.alleles:
            v = likelihoods.values[allele][r]
            if v > best:
                best = v
        qualified: List[float] = []
        v = likelihoods.values[ref_allele][r]
        if not math.isnan(v) and v < best:
            qualified.append(v)
        for i in range(non_ref_index):
            v = likelihoods.values[alt_alleles[i]][r]
            if not math.isnan(v) and v < best:
                qualified.append(v)
        if len(qualified) == 0:
            non_ref_liks[r] = float("nan") if len(alt_alleles) <= 1 else best
            continue
        if len(qualified) == 1:
            median = qualified[0]
        else:
            qualified.sort()
            half = (len(qualified) + 1) // 2
            lo = qualified[half - 1]
            hi = qualified[half]
            median = lo + ((1 - len(qualified) % 2) / 2) * (hi - lo)
        if math.isnan(median) and non_ref_index > 1:
            median = best
        non_ref_liks[r] = median


# ---------------------------------------------------------------------------
# Genotype likelihoods (assigngls.go:466-499, 2102-2145)
# ---------------------------------------------------------------------------


def for_each_alt_genotype(alt: List[str], ref_and_one, one_alt, two_alts) -> None:
    """VCF genotype ordering (assigngls.go:466-479)."""
    index = 1
    for j, a in enumerate(alt):
        ref_and_one(index, a)
        index += 1
        for i in range(j):
            two_alts(index, alt[i], a)
            index += 1
        one_alt(index, a)
        index += 1


def _single_component_gl(likelihoods: List[float]) -> float:
    gl = 0.0
    for l in likelihoods:
        gl += l + LOG10_PLOIDY
    return gl


def _two_component_gl(lik0: List[float], lik1: List[float]) -> float:
    gl = 0.0
    for r in range(len(lik0)):
        gl += tables.approximate_log10_sum_log10(lik0[r], lik1[r])
    return gl


def calculate_genotype_likelihoods(variant: Variant,
                                   likelihoods: ReadAlleleLikelihoods
                                   ) -> Tuple[List[float], List[int]]:
    """(reference: calculateGenotypeLikelihoods, assigngls.go:2102-2145)"""
    denominator = len(likelihoods.alns) * LOG10_PLOIDY
    n_alleles = len(variant.alt) + 1
    gls = [0.0] * ((n_alleles * n_alleles + n_alleles) // 2)
    lik_ref = likelihoods.values[variant.ref]
    max_gl = _single_component_gl(lik_ref) - denominator
    gls[0] = max_gl
    state = {"max": max_gl}

    def ref_one(index, a):
        gl = _two_component_gl(lik_ref, likelihoods.values[a]) - denominator
        if gl > state["max"]:
            state["max"] = gl
        gls[index] = gl

    def one(index, a):
        gl = _single_component_gl(likelihoods.values[a]) - denominator
        if gl > state["max"]:
            state["max"] = gl
        gls[index] = gl

    def two(index, a1, a2):
        gl = _two_component_gl(likelihoods.values[a1], likelihoods.values[a2]) - denominator
        if gl > state["max"]:
            state["max"] = gl
        gls[index] = gl

    for_each_alt_genotype(variant.alt, ref_one, one, two)
    max_gl = state["max"]
    pls: List[int] = [0] * len(gls)
    for i in range(len(gls)):
        adjusted = -10 * (gls[i] - max_gl)
        if adjusted > np.iinfo(np.int32).max:
            pls[i] = np.iinfo(np.int32).max
            gls[i] = float(np.iinfo(np.int32).max) / -10
        else:
            r = _go_round(adjusted)
            pls[i] = int(r)
            gls[i] = r / -10
    return gls, pls


def _go_round(x: float) -> float:
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def find_best_alleles(n_alleles: int, gls: List[float]) -> Tuple[int, int, int]:
    k = 0
    maxgl = float("-inf")
    a1 = a2 = best = 0
    for j in range(n_alleles):
        for i in range(j + 1):
            if gls[k] > maxgl:
                maxgl, a1, a2, best = gls[k], i, j, k
            k += 1
    return a1, a2, best


def subset_alleles(vc: Variant, gls: List[float], subset: List[str]
                   ) -> Tuple[Optional[List[int]], Optional[List[float]]]:
    """(reference: subsetAlleles, assigngls.go:505-565)"""
    gls_sub = [0.0] * ((8 * 8 + 8) // 2)
    max_gl = gls[0]
    gls_sub[0] = max_gl
    state = {"i": 1, "max": max_gl}

    def ref_or_one(index, alt):
        if alt in subset:
            gl = gls[index]
            if gl > state["max"]:
                state["max"] = gl
            gls_sub[state["i"]] = gl
            state["i"] += 1

    def two(index, alt1, alt2):
        if alt1 in subset and alt2 in subset:
            gl = gls[index]
            if gl > state["max"]:
                state["max"] = gl
            gls_sub[state["i"]] = gl
            state["i"] += 1

    for_each_alt_genotype(vc.alt, ref_or_one, ref_or_one, two)
    n = state["i"]
    max_gl = state["max"]
    s = 0.0
    for i in range(n):
        e = gls_sub[i] - max_gl
        s += e
        gls_sub[i] = e
    if s < -0.1:
        pls = []
        for i in range(n):
            adjusted = -10 * gls_sub[i]
            if adjusted > np.iinfo(np.int32).max:
                pls.append(int(np.iinfo(np.int32).max))
            else:
                pls.append(int(_go_round(adjusted)))
        return pls, gls_sub[:n]
    return None, None


# ---------------------------------------------------------------------------
# Allele frequency calculation (assigngls.go:567-700)
# ---------------------------------------------------------------------------

ALLELE_FREQUENCY_DUMMY_PRIOR = -1e-10
LOG10_TWO_COMPONENT_COMBINATION_COUNT = (
    math.lgamma(3) - math.lgamma(2) - math.lgamma(2)) / math.log(10)


@dataclass
class AlleleFrequency:
    log10_posteriors: Tuple[float, float] = (0.0, 0.0)
    log10_p_ref: Dict[str, float] = field(default_factory=dict)
    allele_counts: List[int] = field(default_factory=list)


def _non_informative_af(n_alt: int) -> AlleleFrequency:
    a0 = ALLELE_FREQUENCY_DUMMY_PRIOR
    a1 = float("-inf") + ALLELE_FREQUENCY_DUMMY_PRIOR
    s = log10_sum_log10(a0, a1)
    return AlleleFrequency(log10_posteriors=(a0 - s, a1 - s),
                           log10_p_ref={}, allele_counts=[0] * n_alt)


def _log10_normalized_genotype_posteriors(log10_posteriors: List[float],
                                          vc: Variant, reduced_alt: List[str],
                                          reduced_gls: List[float],
                                          log10_af: Dict[str, float]) -> None:
    af_ref = log10_af[vc.ref]
    max_value = reduced_gls[0] + 2 * af_ref
    ref_with_alt = LOG10_TWO_COMPONENT_COMBINATION_COUNT + af_ref
    log10_posteriors[0] = max_value
    state = {"max": max_value, "maxi": 0}

    def ref_one(index, alt):
        value = ref_with_alt + reduced_gls[index] + log10_af[alt]
        if value > state["max"]:
            state["max"] = value
            state["maxi"] = index
        log10_posteriors[index] = value

    def one(index, alt):
        value = reduced_gls[index] + 2 * log10_af[alt]
        if value > state["max"]:
            state["max"] = value
            state["maxi"] = index
        log10_posteriors[index] = value

    def two(index, alt1, alt2):
        value = (LOG10_TWO_COMPONENT_COMBINATION_COUNT + reduced_gls[index]
                 + log10_af[alt1] + log10_af[alt2])
        if value > state["max"]:
            state["max"] = value
            state["maxi"] = index
        log10_posteriors[index] = value

    for_each_alt_genotype(reduced_alt, ref_one, one, two)
    max_value, max_index = state["max"], state["maxi"]
    if math.isinf(max_value) and max_value < 0:
        log10_sum = max_value
    else:
        s = 1.0
        for i, value in enumerate(log10_posteriors):
            if i == max_index or (math.isinf(value) and value < 0):
                continue
            s += 10 ** (value - max_value)
        log10_sum = max_value + math.log10(s)
    for i in range(len(log10_posteriors)):
        log10_posteriors[i] -= log10_sum


def compute_log10_non_ref(params: HCParams, vc: Variant, reduced_alt: List[str],
                          reduced_pls: Optional[List[int]]) -> AlleleFrequency:
    """(reference: computeLog10NonRef, assigngls.go:652-830)"""
    if not reduced_pls:
        return _non_informative_af(len(reduced_alt))
    num_alleles = len(reduced_alt) + 1
    prior_pseudocounts = [params.ref_pseudocount]
    for a in reduced_alt:
        if len(a) <= 1 or is_symbolic_allele(a):
            prior_pseudocounts.append(params.indel_pseudocount)
        else:
            prior_pseudocounts.append(params.snp_pseudocount)
    reduced_gls = [0.0] * ((8 * 8 + 8) // 2)
    for i, pl in enumerate(reduced_pls):
        reduced_gls[i] = pl / -10
    allele_counts: Dict[str, float] = {}
    new_allele_counts: Dict[str, float] = {}
    flat = -math.log10(num_alleles)
    log10_af = {vc.ref: flat}
    for a in reduced_alt:
        log10_af[a] = flat
    log10_posteriors = [0.0] * len(reduced_pls)
    posterior_pseudocounts = [0.0] * num_alleles
    while True:
        new_allele_counts[vc.ref] = float("-inf")
        for a in reduced_alt:
            new_allele_counts[a] = float("-inf")
        _log10_normalized_genotype_posteriors(log10_posteriors, vc, reduced_alt,
                                              reduced_gls, log10_af)
        new_allele_counts[vc.ref] = log10_sum_log10(
            new_allele_counts[vc.ref], log10_posteriors[0] + LOG10_PLOIDY)

        def ref_one(index, alt):
            inc = log10_posteriors[index] + LOG10_ONE
            new_allele_counts[vc.ref] = log10_sum_log10(new_allele_counts[vc.ref], inc)
            new_allele_counts[alt] = log10_sum_log10(new_allele_counts[alt], inc)

        def one(index, alt):
            new_allele_counts[alt] = log10_sum_log10(
                new_allele_counts[alt], log10_posteriors[index] + LOG10_PLOIDY)

        def two(index, alt1, alt2):
            inc = log10_posteriors[index] + LOG10_ONE
            new_allele_counts[alt1] = log10_sum_log10(new_allele_counts[alt1], inc)
            new_allele_counts[alt2] = log10_sum_log10(new_allele_counts[alt2], inc)

        for_each_alt_genotype(reduced_alt, ref_one, one, two)
        for a in list(new_allele_counts):
            new_allele_counts[a] = 10 ** new_allele_counts[a]
        nac = new_allele_counts[vc.ref]
        max_diff = abs(allele_counts.get(vc.ref, 0.0) - nac)
        total = prior_pseudocounts[0] + nac
        posterior_pseudocounts[0] = total
        for i, a in enumerate(reduced_alt):
            nac_a = new_allele_counts[a]
            diff = abs(allele_counts.get(a, 0.0) - nac_a)
            if diff > max_diff:
                max_diff = diff
            value = prior_pseudocounts[i + 1] + nac_a
            total += value
            posterior_pseudocounts[i + 1] = value
        allele_counts, new_allele_counts = new_allele_counts, allele_counts
        log10_af[vc.ref] = math.log10(posterior_pseudocounts[0] / total)
        for i, a in enumerate(reduced_alt):
            log10_af[a] = math.log10(posterior_pseudocounts[i + 1] / total)
        if max_diff <= 0.1:
            break

    _log10_normalized_genotype_posteriors(log10_posteriors, vc, reduced_alt,
                                          reduced_gls, log10_af)
    non_variant_posteriors = [log10_posteriors[0]]

    def collect_star(index, alt):
        if alt == SPAN_DEL:
            non_variant_posteriors.append(log10_posteriors[index])

    for_each_alt_genotype(reduced_alt, collect_star, lambda i, a: None,
                          lambda i, a, b: None)
    if len(non_variant_posteriors) == 1:
        log10_p_no_variant = log10_posteriors[0]
    else:
        log10_p_no_variant = min(0.0, log10_sum_log10(
            non_variant_posteriors[0], non_variant_posteriors[1]))

    log10_p_of_zero: Dict[str, float] = {}
    if num_alleles == 2:
        log10_p_of_zero[reduced_alt[0]] = log10_p_no_variant
    else:
        absent: Dict[str, List[float]] = {a: [log10_posteriors[0]] for a in reduced_alt}

        def ref_or_one(index, alt):
            p = log10_posteriors[index]
            for a in reduced_alt:
                if a != alt:
                    absent[a].append(p)

        def two_absent(index, alt1, alt2):
            p = log10_posteriors[index]
            for a in reduced_alt:
                if a != alt1 and a != alt2:
                    absent[a].append(p)

        for_each_alt_genotype(reduced_alt, ref_or_one, ref_or_one, two_absent)
        for a in reduced_alt:
            log10_p_of_zero[a] = min(0.0, log10_sum_log10_slice(absent[a]))

    yes_no = (log10_p_no_variant, log10_one_minus_pow10(log10_p_no_variant))
    af0 = yes_no[0] + ALLELE_FREQUENCY_DUMMY_PRIOR
    af1 = yes_no[1] + ALLELE_FREQUENCY_DUMMY_PRIOR
    s = log10_sum_log10(af0, af1)
    int_counts = [int(np.int32(_go_round(allele_counts[a]))) for a in reduced_alt]
    return AlleleFrequency(
        log10_posteriors=(af0 - s, af1 - s),
        log10_p_ref=log10_p_of_zero,
        allele_counts=int_counts,
    )


# ---------------------------------------------------------------------------
# Deletions side info (side-channel.go semantics, sequentialized)
# ---------------------------------------------------------------------------


class DeletionsHandler:
    """Sequential stand-in for the reference's side channel: the slice of
    (start, end) deletions flows from one region to the next (reference:
    side-channel.go:26-132). ``consulted`` records whether
    :func:`is_vc_covered_by_deletion` read the slice; until it does, the
    slice is only appended to, so the outgoing slice is the incoming one
    followed by this region's own entries."""

    def __init__(self, incoming: Optional[List[Tuple[int, int]]]) -> None:
        self.slice: List[Tuple[int, int]] = list(incoming or [])
        self.consulted = False


def is_vc_covered_by_deletion(deletions: DeletionsHandler, vc: Variant) -> bool:
    deletions.consulted = True
    i = 0
    while i < len(deletions.slice):
        d = deletions.slice[i]
        if d[1] < vc.pos:
            del deletions.slice[i]
        elif d[0] != vc.pos:
            return True
        else:
            i += 1
    return False


# ---------------------------------------------------------------------------
# calculateGenotypes (assigngls.go:832-1037)
# ---------------------------------------------------------------------------


def compute_output_alleles(params: HCParams, merged: Variant,
                           reduced_alt: List[str], af: AlleleFrequency,
                           deletions: DeletionsHandler
                           ) -> Tuple[List[str], List[int], bool]:
    """(reference: computeOutputAlleles, assigngls.go:845-888)"""
    site_is_monomorphic = True
    ref_size = len(merged.ref)
    if len(reduced_alt) == 1 and reduced_alt[0] == NON_REF:
        plausible = af.log10_p_ref[NON_REF] + 1.0e-10 < params.standard_confidence_for_calling_by_min10
        site_is_monomorphic = site_is_monomorphic and not plausible
        output_alleles = reduced_alt
        mle_counts = af.allele_counts
        if ref_size > 0:
            deletions.slice.append((merged.pos, merged.pos + ref_size))
    else:
        output_alleles = []
        mle_counts = []
        for i, a in enumerate(reduced_alt):
            plausible = af.log10_p_ref[a] + 1.0e-10 < params.standard_confidence_for_calling_by_min10
            spurious_span_del = a == SPAN_DEL and not is_vc_covered_by_deletion(deletions, merged)
            to_output = ((params.confidence_mode != "NONE" or plausible or a == NON_REF)
                         and not spurious_span_del)
            site_is_monomorphic = site_is_monomorphic and not (plausible and not spurious_span_del)
            if to_output:
                output_alleles.append(a)
                mle_counts.append(af.allele_counts[i])
                deletion_size = ref_size
                if not is_symbolic_allele(a):
                    deletion_size -= len(a)
                if deletion_size > 0:
                    deletions.slice.append((merged.pos, merged.pos + deletion_size))
    return output_alleles, mle_counts, site_is_monomorphic


def calculate_genotypes(params: HCParams, variant: Variant, pls: Optional[List[int]],
                        gls: List[float], deletions: DeletionsHandler
                        ) -> Tuple[Optional[Variant], Optional[List[float]]]:
    """(reference: calculateGenotypes, assigngls.go:881-1037)"""
    if len(variant.alt) > 49:
        return None, None
    reduced_alt = variant.alt
    reduced_pls = pls
    nof_non_proper_alts = 0
    nof_reduced_alt = len(reduced_alt)
    has_non_ref = params.confidence_mode != "NONE"
    if has_non_ref:
        nof_non_proper_alts = 1
        nof_reduced_alt -= 1
    if nof_reduced_alt > 6:
        a1, a2, _ = find_best_alleles(len(reduced_alt) + 1, gls)
        best_alt = 0
        one_index = 0
        if 0 < a1 < nof_reduced_alt + 1:
            best_alt = 1
            one_index = a1
        if 0 < a2 < nof_reduced_alt + 1 and a1 != a2:
            best_alt += 1
            one_index = a2
        new_alt = list(variant.alt[:6]) + [""] * (nof_non_proper_alts)
        if len(new_alt) < 6 + nof_non_proper_alts:
            new_alt += [""] * (6 + nof_non_proper_alts - len(new_alt))
        if best_alt == 1:
            one_index -= 1
            if one_index > 5:
                new_alt[5] = variant.alt[one_index]
        elif best_alt == 2:
            a1 -= 1
            a2 -= 1
            if a1 > 4:
                new_alt[4] = variant.alt[a1]
                new_alt[5] = variant.alt[a2]
            elif a2 > 5:
                new_alt[5] = variant.alt[a2]
        if has_non_ref:
            new_alt[6] = NON_REF
        reduced_alt = new_alt
        reduced_pls, _ = subset_alleles(variant, gls, reduced_alt)
    af = compute_log10_non_ref(params, variant, reduced_alt, reduced_pls)
    output_alleles, mle_counts, site_is_monomorphic = compute_output_alleles(
        params, variant, reduced_alt, af, deletions)
    if len(output_alleles) == 1 and output_alleles[0] == SPAN_DEL:
        return None, None
    if site_is_monomorphic and (not output_alleles or output_alleles[0] != NON_REF):
        return None, None
    if params.confidence_mode != "NONE" or not site_is_monomorphic:
        log10_confidence = af.log10_posteriors[0]
    else:
        log10_confidence = af.log10_posteriors[1]
    if log10_confidence == 0:
        log10_confidence = 0.0
    phred_scaled_confidence = -10 * log10_confidence
    if phred_scaled_confidence == 0:
        phred_scaled_confidence = 0.0
    filt: List[str] = []
    if not (phred_scaled_confidence >= params.standard_confidence_for_calling):
        if not output_alleles or output_alleles[0] != NON_REF:
            return None, None
        filt = ["LowQual"]
    call = Variant(source="HC_call", chrom=variant.chrom, pos=variant.pos,
                   ref=variant.ref, alt=list(output_alleles),
                   qual=phred_scaled_confidence, filter=filt,
                   info=variant.info)
    gt = Genotype()
    out_gls: Optional[List[float]] = gls
    if not output_alleles:
        out_gls = None
        call.alt = []
        gt.gt = list(NO_VARIATION_GT)
    else:
        new_pls, new_gls = subset_alleles(variant, gls, output_alleles)
        out_gls = new_gls
        if new_pls is None:
            gt.gt = list(NO_CALL_GT)
        else:
            a1, a2, bestgl = find_best_alleles(len(output_alleles) + 1, new_gls)
            gt.gt = [a1, a2]
            gt.data["PL"] = new_pls
            qual = float("-inf")
            for i, g in enumerate(new_gls):
                if i != bestgl and g >= qual:
                    qual = g
            qual = new_gls[bestgl] - qual
            if qual < 0:
                max_value = new_gls[bestgl]
                s = 0.0
                for i in range(len(new_gls)):
                    v = 10 ** (new_gls[i] - max_value)
                    new_gls[i] = v
                    s += v
                log10_p_error = math.log10(1 - new_gls[bestgl] / s)
            else:
                log10_p_error = -qual
            gt.data["GQ"] = min(int(_go_round(log10_p_error * -10)), MAX_GENOTYPE_QUAL)
    if mle_counts:
        call.info["MLEAC"] = list(mle_counts)
        idiv = sum(1 for a in gt.gt if a != -1)
        if idiv == 0:
            mle_freqs = [float("nan")] * len(mle_counts)
        else:
            mle_freqs = [min(1.0, c / idiv) for c in mle_counts]
        call.info["MLEAF"] = mle_freqs
    call.genotypes = [gt]
    return call, out_gls


# ---------------------------------------------------------------------------
# ExcessHet (assigngls.go:1060-1176)
# ---------------------------------------------------------------------------

MIN_NEEDED_VALUE = 1.0e-16
PHRED_SCALED_MIN_P_VALUE = -10 * math.log10(MIN_NEEDED_VALUE)


def compute_diploid_genotype_counts(vc: Variant, gls: List[float]) -> Tuple[int, int, int]:
    if "PL" not in vc.genotypes[0].data:
        return 0, 0, 0
    idx_aa, idx_ab, idx_bb = 0, 1, 2
    gt = vc.genotypes[0].gt
    if len(vc.alt) != 1:
        if gt[0] != gt[1] and gt[0] != 0 and gt[1] != 0:
            return 0, 0, 1
        if gt[1] != 0:
            a2 = gt[1]
            idx_ab = (a2 * (a2 + 1) // 2) + 0
            idx_bb = idx_ab + a2
        elif gt[0] != 0:
            a2 = gt[0]
            idx_ab = (a2 * (a2 + 1) // 2) + 0
            idx_bb = idx_ab + a2
    log10_sum = log10_sum_log10_slice(gls)
    ref_count = int(_go_round(10 ** (gls[idx_aa] - log10_sum)))
    het_count = int(_go_round(10 ** (gls[idx_ab] - log10_sum)))
    hom_count = int(_go_round(10 ** (gls[idx_bb] - log10_sum)))
    return ref_count, het_count, hom_count


def exact_test(het_count: int, ref_count: int, hom_count: int) -> float:
    """(reference: exactTest, assigngls.go:1102-1166)"""
    if ref_count < hom_count:
        obs_hom_r, obs_hom_c = ref_count, hom_count
    else:
        obs_hom_r, obs_hom_c = hom_count, ref_count
    rare_copies = 2 * obs_hom_r + het_count
    if rare_copies <= 1:
        return 0.5
    n = het_count + obs_hom_c + obs_hom_r
    probs = [0.0] * (rare_copies + 1)
    mid = rare_copies * (2 * n - rare_copies) // (2 * n - 1)
    if mid % 2 != rare_copies % 2:
        mid += 1
    probs[mid] = 1.0
    total = 1.0
    cur_hets = mid
    cur_hom_r = (rare_copies - mid) // 2
    cur_hom_c = n - cur_hets - cur_hom_r
    while cur_hets >= 2:
        potential = probs[cur_hets] * (cur_hets * (cur_hets - 1)) / (4 * (cur_hom_r + 1) * (cur_hom_c + 1))
        if potential < MIN_NEEDED_VALUE:
            break
        probs[cur_hets - 2] = potential
        total += potential
        cur_hets -= 2
        cur_hom_r += 1
        cur_hom_c += 1
    cur_hets = mid
    cur_hom_r = (rare_copies - mid) // 2
    cur_hom_c = n - cur_hets - cur_hom_r
    while cur_hets <= rare_copies - 2:
        potential = probs[cur_hets] * 4 * (cur_hom_r * cur_hom_c) / ((cur_hets + 2) * (cur_hets + 1))
        if potential < MIN_NEEDED_VALUE:
            break
        probs[cur_hets + 2] = potential
        total += potential
        cur_hets += 2
        cur_hom_r -= 1
        cur_hom_c -= 1
    right_pval = probs[het_count] / (2 * total)
    if het_count == rare_copies:
        return right_pval
    prob_sum = 0.0
    for i in range(het_count + 1, len(probs)):
        prob_sum += probs[i]
    return right_pval + prob_sum / total


def calculate_eh(vc: Variant, gls: List[float]) -> float:
    ref_count, het_count, hom_count = compute_diploid_genotype_counts(vc, gls)
    pval = exact_test(het_count, ref_count, hom_count)
    if pval < 10e-60:
        return PHRED_SCALED_MIN_P_VALUE
    return -10 * math.log10(pval)


# ---------------------------------------------------------------------------
# Mann-Whitney U rank-sum tests (assigngls.go:1039-1056, 1178-1358)
# ---------------------------------------------------------------------------

SQRT2 = math.sqrt(2)


def erf_inv(x: float) -> float:
    """(reference: erfInv, assigngls.go:1185-1252) — polynomial inverse erf."""
    w = -math.log((1 - x) * (1 + x)) if abs(x) < 1 else float("inf")
    if w < 6.25:
        w -= 3.125
        p = -3.6444120640178196996e-21
        for c in (-1.685059138182016589e-19, 1.2858480715256400167e-18,
                  1.115787767802518096e-17, -1.333171662854620906e-16,
                  2.0972767875968561637e-17, 6.6376381343583238325e-15,
                  -4.0545662729752068639e-14, -8.1519341976054721522e-14,
                  2.6335093153082322977e-12, -1.2975133253453532498e-11,
                  -5.4154120542946279317e-11, 1.051212273321532285e-09,
                  -4.1126339803469836976e-09, -2.9070369957882005086e-08,
                  4.2347877827932403518e-07, -1.3654692000834678645e-06,
                  -1.3882523362786468719e-05, 0.0001867342080340571352,
                  -0.00074070253416626697512, -0.0060336708714301490533,
                  0.24015818242558961693, 1.6536545626831027356):
            p = c + p * w
    elif w < 16.0:
        w = math.sqrt(w) - 3.25
        p = 2.2137376921775787049e-09
        for c in (9.0756561938885390979e-08, -2.7517406297064545428e-07,
                  1.8239629214389227755e-08, 1.5027403968909827627e-06,
                  -4.013867526981545969e-06, 2.9234449089955446044e-06,
                  1.2475304481671778723e-05, -4.7318229009055733981e-05,
                  6.8284851459573175448e-05, 2.4031110387097893999e-05,
                  -0.0003550375203628474796, 0.00095328937973738049703,
                  -0.0016882755560235047313, 0.0024914420961078508066,
                  -0.0037512085075692412107, 0.005370914553590063617,
                  1.0052589676941592334, 3.0838856104922207635):
            p = c + p * w
    elif not math.isinf(w):
        w = math.sqrt(w) - 5.0
        p = -2.7109920616438573243e-11
        for c in (-2.5556418169965252055e-10, 1.5076572693500548083e-09,
                  -3.7894654401267369937e-09, 7.6157012080783393804e-09,
                  -1.4960026627149240478e-08, 2.9147953450901080826e-08,
                  -6.7711997758452339498e-08, 2.2900482228026654717e-07,
                  -9.9298272942317002539e-07, 4.5260625972231537039e-06,
                  -1.9681778105531670567e-05, 7.5995277030017761139e-05,
                  -0.00021503011930044477347, -0.00013871931833623122026,
                  1.0103004648645343977, 4.8499064014085844221):
            p = c + p * w
    else:
        p = float("inf")
    return p * x


class RankSumTest:
    def __init__(self) -> None:
        self.alts: List[float] = []
        self.refs: List[float] = []

    def mann_whitney_u(self) -> Tuple[float, bool]:
        """(reference: mannWithneyU, assigngls.go:1253-1358). Ranks use
        float32 accumulation like the reference."""
        n1 = len(self.alts)
        n2 = len(self.refs)
        if n1 == 0 or n2 == 0:
            return 0.0, False
        ranks = [[v, 0.0, True] for v in self.alts] + [[v, 0.0, False] for v in self.refs]
        ranks.sort(key=lambda t: t[0])
        for i, r in enumerate(ranks):
            r[1] = np.float32(i + 1)
        nties = 0.0
        i = 0
        while i < len(ranks):
            rank = np.float32(ranks[i][1])
            count = 1
            j = i + 1
            while j < len(ranks) and ranks[j][0] == ranks[i][0]:
                rank = np.float32(rank + ranks[j][1])
                count += 1
                j += 1
            if count > 1:
                rank = np.float32(rank / np.float32(count))
                for k in range(i, i + count):
                    ranks[k][1] = rank
                if count != len(ranks):
                    nties += count ** 3 - count
            i += count
        r = np.float32(0.0)
        for rr in ranks:
            if rr[2]:
                r = np.float32(r + rr[1])
        u = float(np.float32(r - np.float32((n1 * (n1 + 1)) // 2)))
        if n1 >= 10 or n2 >= 10:
            m = (n1 * n2) / 2
            correction = -0.5 if nties != 0 else 0.0
            sigma = math.sqrt((n1 * n2 / 12) * ((n1 + n2 + 1) - nties / ((n1 + n2) * (n1 + n2 - 1))))
            z = (u - m - correction) / sigma
        else:
            # exact permutation distribution (assigngls.go:1305-1352)
            new_u_delta = float((n1 * (n1 + 1)) // 2)
            histogram: Dict[int, int] = {}
            total_sum = 0
            permutation = [0] * n1 + [1] * n2
            while True:
                new_u = 0.0
                for i2, grouping in enumerate(permutation):
                    if grouping == 0:
                        new_u += float(ranks[i2][1])
                new_u -= new_u_delta
                key = int(_go_round(2 * new_u))
                histogram[key] = histogram.get(key, 0) + 1
                total_sum += 1
                k = -1
                for i2 in range(len(permutation) - 2, -1, -1):
                    if permutation[i2] < permutation[i2 + 1]:
                        k = i2
                        break
                if k == -1:
                    break
                l = -1
                for i2 in range(len(permutation) - 1, k, -1):
                    if permutation[k] < permutation[i2]:
                        l = i2
                        break
                permutation[k], permutation[l] = permutation[l], permutation[k]
                permutation[k + 1 :] = permutation[k + 1 :][::-1]
            u2 = int(_go_round(2 * u))
            sum_smaller = histogram.get(u2, 0) / 2
            for key in sorted(k for k in histogram if k < u2):
                sum_smaller += histogram[key]
            p = sum_smaller / total_sum
            z = SQRT2 * erf_inv(2 * p - 1)
        return z, not math.isnan(z)


# ---------------------------------------------------------------------------
# Fisher strand / hypergeometric (assigngls.go:1360-1460)
# ---------------------------------------------------------------------------

HALF_LOG2_PI = 0.5 * math.log(6.283185307179586)
EXACT_STIRLING_ERRORS = [
    0, 0.15342640972002736, 0.08106146679532726, 0.05481412105191765, 0.0413406959554093,
    0.03316287351993629, 0.02767792568499834, 0.023746163656297496, 0.020790672103765093,
    0.018488450532673187, 0.016644691189821193, 0.015134973221917378, 0.013876128823070748,
    0.012810465242920227, 0.01189670994589177, 0.011104559758206917, 0.010411265261972096,
    0.009799416126158804, 0.009255462182712733, 0.008768700134139386, 0.00833056343336287,
    0.00793411456431402, 0.007573675487951841, 0.007244554301320383, 0.00694284010720953,
    0.006665247032707682, 0.006408994188004207, 0.006171712263039458, 0.0059513701127588475,
    0.0057462165130101155, 0.005554733551962801,
]
REL_ERR = 1 - 10e-7
MIN_LOG10_SCALED_QUAL = math.log10(5e-324)


def get_deviance_part(x: float, mu: float) -> float:
    d = x - mu
    t = x + mu
    if abs(d) < 0.1 * t:
        v = d / t
        s1 = v * d
        s = float("nan")
        ej = 2 * x * v
        v *= v
        j = 1
        while s1 != s:
            s = s1
            ej *= v
            s1 += ej / (j * 2 + 1)
            j += 1
        return s1
    return x * math.log(x / mu) + mu - x


def get_stirling_error(z: float) -> float:
    if z < 15:
        z2 = 2 * z
        if math.floor(z2) == z2:
            return EXACT_STIRLING_ERRORS[int(z2)]
        return math.lgamma(z + 1) - (z + 0.5) * math.log(z) + z - HALF_LOG2_PI
    z2 = z * z
    return (0.08333333333333333 - (0.002777777777777778 - (7.936507936507937e-4 - (
        5.952380952380953e-4 - 8.417508417508417e-4 / z2) / z2) / z2) / z2) / z


def log_binomial_probability(x: int, n: int, p: float, q: float) -> float:
    fn = float(n)
    if x == 0:
        if p < 0.1:
            return -get_deviance_part(fn, fn * q) - fn * p
        return fn * math.log(q)
    if x == n:
        if q < 0.1:
            return -get_deviance_part(fn, fn * p) - fn * q
        return fn * math.log(p)
    fx = float(x)
    fnx = float(n - x)
    ret = (get_stirling_error(fn) - get_stirling_error(fx) - get_stirling_error(fnx)
           - get_deviance_part(fx, fn * p) - get_deviance_part(fnx, fn * q))
    f = 6.283185307179586 * fx * fnx / fn
    return ret + -0.5 * math.log(f)


class HypergeometricDistribution:
    def __init__(self, population_size: int, number_of_successes: int, sample_size: int):
        fpop = float(population_size)
        self.population_size = population_size
        self.number_of_successes = number_of_successes
        self.sample_size = sample_size
        self.lower = max(0, number_of_successes - (population_size - sample_size))
        self.upper = min(sample_size, number_of_successes)
        self.p = sample_size / fpop
        self.q = (population_size - sample_size) / fpop
        self.p3 = log_binomial_probability(sample_size, population_size, self.p, self.q)

    def log_probability(self, x: int) -> float:
        if self.lower <= x <= self.upper:
            p1 = log_binomial_probability(x, self.number_of_successes, self.p, self.q)
            p2 = log_binomial_probability(self.sample_size - x,
                                          self.population_size - self.number_of_successes,
                                          self.p, self.q)
            return p1 + p2 - self.p3
        return float("-inf")


# ---------------------------------------------------------------------------
# Annotations (assigngls.go:1462-1748)
# ---------------------------------------------------------------------------


def compute_sor(contingency) -> float:
    """Symmetric odds ratio of the strand 2x2 table with +1 pseudocounts
    (reference: assigngls.go SOR block; contingency order is
    refFwd, refRev, altFwd, altRev)."""
    t00 = contingency[0] + 1.0
    t01 = contingency[1] + 1.0
    t10 = contingency[2] + 1.0
    t11 = contingency[3] + 1.0
    ratio = (t00 / t01) * (t11 / t10) + (t01 / t00) * (t10 / t11)
    if t00 > t01:
        t00, t01 = t01, t00
    ref_ratio = t00 / t01
    if t10 > t11:
        t10, t11 = t11, t10
    alt_ratio = t10 / t11
    return math.log(ratio) + math.log(ref_ratio) - math.log(alt_ratio)


def compute_fs(contingency) -> float:
    """Phred-scaled two-sided Fisher's exact strand-bias p-value
    (reference: assigngls.go FS block; hypergeometric tail with the
    GATK >400 normalization and REL_ERR inclusion threshold)."""
    total = sum(contingency)
    if total <= 2:
        return 0.0
    ct = list(contingency)
    if total > 400:
        norm = total / 200
        ct = [int(c / norm) for c in ct]
    m = ct[0] + ct[1]
    n = ct[2] + ct[3]
    k = ct[0] + ct[2]
    lo = max(0, k - n)
    hi = min(k, m)
    p_value = 0.0
    if hi > lo:
        dist = HypergeometricDistribution(m + n, m, k)
        logds = [dist.log_probability(i) for i in range(lo, hi + 1)]
        threshold = logds[ct[0] - lo] * REL_ERR
        i = 0
        while i < len(logds):
            if logds[i] <= threshold:
                logds[i] = logds[i] * math.log10(math.e)
                i += 1
            else:
                del logds[i]
        p_value = abs(-10 * max(
            math.log10(max(min(10 ** log10_sum_log10_slice(logds), 1.0), 1e-320)),
            MIN_LOG10_SCALED_QUAL))
    return p_value


def calc_alignment_byte_array_offset(cigar: List[sw.CigOp], offset: int) -> int:
    pos = 0
    alignment_pos = 0
    for length, op in cigar:
        if op in "IS":
            pos += length
            if pos >= offset:
                return alignment_pos
        elif op == "D":
            alignment_pos += length
        elif op in "M=X":
            if pos + length - 1 >= offset:
                return alignment_pos + offset - pos
            pos += length
            alignment_pos += length
    return alignment_pos


def nof_aligned_bases_with_soft_clips(cigar: List[sw.CigOp]) -> int:
    return sum(ln for ln, op in cigar if op in "M=XS")


# randomized-QD state: the reference's DEFAULT build jitters QD >= 35
# with Gaussian noise (filters/randomized-max-qd.go:30-44, matching
# GATK); the fixed_high_qd build clamps to 30 for deterministic diffing.
# The repo defaults to the fixed variant; --randomized-qd enables the
# jitter (numpy normals — same distribution as the reference's Go
# rand stream, not the same values, as the feature is nondeterministic
# by design).
_QD_RANDOM: list = [None]


def set_randomized_qd(enabled: bool) -> None:
    if enabled and _QD_RANDOM[0] is not None:
        return  # keep the live stream (one seed per process, like the reference)
    _QD_RANDOM[0] = np.random.RandomState(487723223) if enabled else None


def fix_too_high_qd(qd: float) -> float:
    """fixed_high_qd build variant (filters/fixed-max-qd.go:25-30), or
    the randomized default when --randomized-qd is on."""
    if qd >= 35:
        rng = _QD_RANDOM[0]
        if rng is not None:
            return 30.0 + rng.standard_normal() * 3.0
        return 30.0
    return qd


def annotate_call(params: HCParams, call: Variant,
                  likelihoods: ReadAlleleLikelihoods, gls: List[float]) -> None:
    """(reference: annotateCall, assigngls.go:1462-1748)"""
    call_gt = call.genotypes[0].gt
    if params.confidence_mode == "NONE":
        an = sum(1 for g in call_gt if g >= 0)
        if an > 0:
            ac = []
            af = []
            for i in range(1, len(call.alt) + 1):
                iac = sum(1 for g in call_gt if g == i)
                ac.append(iac)
                af.append(iac / an if an else 0.0)
            call.info["AN"] = an
            call.info["AC"] = ac
            call.info["AF"] = af
    allele_counts: Dict[str, int] = {}
    depth = 0
    contingency = [0, 0, 0, 0]
    square_sum = 0
    num_reads_used = 0
    base_quality = RankSumTest()
    mapping_quality = RankSumTest()
    read_position = RankSumTest()
    for r, aln in enumerate(likelihoods.alns):
        if aln.mapq != 255:
            square_sum += aln.mapq * aln.mapq
            num_reads_used += 1

        # first pass over ref+alt alleles; best starts as ref
        # (assigngls.go:1510-1530)
        best_a, best_l = call.ref, likelihoods.values[call.ref][r]
        second_a, second_l = "", float("-inf")
        for a in call.alt:
            lv = likelihoods.values[a][r]
            if lv > best_l:
                second_a, second_l = best_a, best_l
                best_a, best_l = a, lv
            elif lv > second_l:
                second_a, second_l = a, lv
        if best_l - second_l < LOG10_INFORMATIVE_THRESHOLD:
            if best_a != call.ref:
                lv = likelihoods.values[call.ref][r]
                if best_l - lv <= LOG10_INFORMATIVE_THRESHOLD:
                    second_a, second_l = best_a, best_l
                    best_a, best_l = call.ref, lv
        if second_a != "" and second_a is not None and best_l - second_l > LOG10_INFORMATIVE_THRESHOLD:
            depth += 1
            allele_counts[best_a] = allele_counts.get(best_a, 0) + 1
        # second pass over ALL alleles (incl NON_REF)
        best_a, best_l = "", float("-inf")
        second_a, second_l = "", float("-inf")
        for a in likelihoods.alleles:
            lv = likelihoods.values[a][r]
            if lv > best_l:
                second_a, second_l = best_a, best_l
                best_a, best_l = a, lv
            elif lv > second_l:
                second_a, second_l = a, lv
        if best_l - second_l < LOG10_INFORMATIVE_THRESHOLD:
            if best_a != call.ref:
                lv = likelihoods.values[call.ref][r]
                if best_l - lv <= LOG10_INFORMATIVE_THRESHOLD:
                    second_a, second_l = best_a, best_l
                    best_a, best_l = call.ref, lv
        if second_a != "" and best_l - second_l > LOG10_INFORMATIVE_THRESHOLD:
            if best_a == call.ref:
                contingency[(aln.flag & 0x10) >> 4] += 1
            elif best_a in call.alt:
                contingency[2 + ((aln.flag & 0x10) >> 4)] += 1
            if aln.mapq != 0 and aln.mapq != 255:
                is_ref = best_a == call.ref
                is_alt = False if is_ref else best_a in call.alt
                if is_ref or is_alt:
                    ss = soft_start(aln)
                    leftmost_safe = max(ss, call.pos)
                    read_coord, ok = get_read_coordinate_for_reference_coordinate(
                        aln.cigar, ss, leftmost_safe, tail=RIGHT)
                    if ok:
                        base_qual = float(aln.qual[read_coord])
                        mapping_qual = float(aln.mapq)
                        if is_ref:
                            base_quality.refs.append(base_qual)
                            mapping_quality.refs.append(mapping_qual)
                        else:
                            base_quality.alts.append(base_qual)
                            mapping_quality.alts.append(mapping_qual)
                    else:
                        raise ValueError("getReadCoordinateForReferenceCoordinate failed")
                    if soft_end(aln) >= call.pos:
                        if call.pos != leftmost_safe:
                            read_coord, ok = get_read_coordinate_for_reference_coordinate(
                                aln.cigar, ss, call.pos, tail=RIGHT)
                        if ok and not is_inside_deletion(aln.cigar, read_coord):
                            leading_hc = aln.cigar[0][0] if aln.cigar[0][1] == "H" else 0
                            trailing_hc = aln.cigar[-1][0] if aln.cigar[-1][1] == "H" else 0
                            read_pos = leading_hc + calc_alignment_byte_array_offset(aln.cigar, read_coord)
                            n_aligned = nof_aligned_bases_with_soft_clips(aln.cigar)
                            num_original = n_aligned + leading_hc + trailing_hc
                            if read_pos > num_original // 2:
                                read_pos = num_original - (read_pos + 1)
                            if is_ref:
                                read_position.refs.append(float(read_pos))
                            else:
                                read_position.alts.append(float(read_pos))
    dp = len(likelihoods.alns)
    if dp > 0:
        call.info["DP"] = dp
        call.info["RAW_MQandDP"] = [square_sum, num_reads_used]
    z, ok = base_quality.mann_whitney_u()
    if ok:
        call.info["BaseQRankSum"] = formatf(z, 3)
    z, ok = mapping_quality.mann_whitney_u()
    if ok:
        call.info["MQRankSum"] = formatf(z, 3)
    z, ok = read_position.mann_whitney_u()
    if ok:
        call.info["ReadPosRankSum"] = formatf(z, 3)
    for g in call_gt:
        if g >= 0:
            call.info["ExcessHet"] = formatf(calculate_eh(call, gls), 4)
            ad = [allele_counts.get(call.ref, 0)]
            for a in call.alt:
                ad.append(allele_counts.get(a, 0))
            call.genotypes[0].data["AD"] = ad
            call.genotypes[0].data["DP"] = depth
            if params.confidence_mode != "NONE":
                call.genotypes[0].data["SB"] = list(contingency)
            break
    if params.confidence_mode == "NONE":
        call.info["SOR"] = formatf(compute_sor(contingency), 3)
        call.info["FS"] = formatf(compute_fs(contingency), 3)
        for g in call_gt:
            if g > 0:
                qd_depth = depth if depth != 0 else len(likelihoods.alns)
                if qd_depth > 0:
                    qd = call.qual / qd_depth
                    qd = fix_too_high_qd(qd)
                    call.info["QD"] = formatf(qd, 2)
                break


# ---------------------------------------------------------------------------
# Phasing (assigngls.go:1750-1924)
# ---------------------------------------------------------------------------

PHASE_01 = "0|1"
PHASE_10 = "1|0"


def is_biallelic(call: Variant) -> bool:
    if len(call.alt) == 1:
        return True
    if len(call.alt) == 2:
        return NON_REF in call.alt
    return False


def construct_haplotype_mapping(calls: List[Variant],
                                called_haplotypes: List[Haplotype]
                                ) -> Dict[int, set]:
    hmap: Dict[int, set] = {}
    for ci, call in enumerate(calls):
        if not is_biallelic(call):
            hmap[ci] = set()
            continue
        alt = call.alt[0]
        with_allele = set()
        if alt == SPAN_DEL:
            for hi, h in enumerate(called_haplotypes):
                for vc in h.events or []:
                    if vc.pos < call.pos <= vc.end():
                        with_allele.add(hi)
        else:
            for hi, h in enumerate(called_haplotypes):
                for vc in h.events or []:
                    if vc.pos == call.pos and alt in vc.alt:
                        with_allele.add(hi)
        hmap[ci] = with_allele
    return hmap


def construct_phase_set_mapping(calls: List[Variant], hmap: Dict[int, set],
                                total_haps: int) -> Tuple[Dict[int, Tuple[int, str]], int]:
    """(reference: constructPhaseSetMapping, assigngls.go:1818-1884)"""
    n = len(calls)
    mapping: Dict[int, Tuple[int, str]] = {}
    unique_counter = 0
    for i in range(n - 1):
        with_call = hmap[i]
        if not with_call:
            continue
        call_on_all = len(with_call) == total_haps
        for j in range(i + 1, n):
            with_comp = hmap[j]
            if not with_comp:
                continue
            comp_on_all = len(with_comp) == total_haps
            if call_on_all or comp_on_all or (
                    len(with_call) == len(with_comp) and with_comp <= with_call):
                if i not in mapping:
                    if j in mapping:
                        return {}, 0
                    mapping[i] = (unique_counter, PHASE_01)
                    mapping[j] = (unique_counter, PHASE_01)
                    unique_counter += 1
                elif j not in mapping:
                    mapping[j] = mapping[i]
            elif len(with_call) + len(with_comp) == total_haps:
                if not (with_call & with_comp):
                    if i not in mapping:
                        if j in mapping:
                            return {}, 0
                        mapping[i] = (unique_counter, PHASE_01)
                        mapping[j] = (unique_counter, PHASE_10)
                        unique_counter += 1
                    elif j not in mapping:
                        pid, phase = mapping[i]
                        mapping[j] = (pid, PHASE_10 if phase == PHASE_01 else PHASE_01)
    return mapping, unique_counter


def phase_vc(vc: Variant, pid: str, phase_gt: str, phase_set: int) -> None:
    gt = vc.genotypes[0]
    if phase_gt == PHASE_10 and gt.gt[0] >= 0 and gt.gt[1] > 0 and gt.gt[0] != gt.gt[1]:
        gt.gt[0], gt.gt[1] = gt.gt[1], gt.gt[0]
    gt.phased = True
    gt.data["PID"] = pid
    gt.data["PGT"] = phase_gt
    gt.data["PS"] = phase_set


def construct_phase_groups(calls: List[Variant],
                           mapping: Dict[int, Tuple[int, str]],
                           unique_counter_end: int) -> None:
    for count in range(unique_counter_end):
        first_index = -1
        for idx, call in enumerate(calls):
            if idx in mapping and mapping[idx][0] == count:
                first_index = idx
                break
        if first_index < 0:
            continue
        first_call = calls[first_index]
        unique_id = "%d_%s_%s" % (first_call.pos, first_call.ref, first_call.alt[0])
        phase_set = first_call.pos
        phase_vc(first_call, unique_id, mapping[first_index][1], phase_set)
        for idx in range(first_index + 1, len(calls)):
            if idx in mapping and mapping[idx][0] == count:
                phase_vc(calls[idx], unique_id, mapping[idx][1], phase_set)


# ---------------------------------------------------------------------------
# Read realignment (realign.go:30-118, 268-396)
# ---------------------------------------------------------------------------


def haplotype_priority(h: Haplotype) -> int:
    result = 1 if h.is_ref else 0
    if h.cigar:
        result += 1 - len(h.cigar)
    return result


_CIGAR_SETS = {"M": "M=X", "I": "IS", "D": "D"}
_CIGAR_TRANSFORM: Dict[Tuple[str, str], Tuple[str, int, int]] = {}
for _a, _b, _c, _ad12, _ad23 in (
    ("M", "M", "M", 1, 1), ("M", "I", "I", 1, 1), ("M", "D", "D", 0, 1),
    ("D", "M", "D", 1, 1), ("D", "D", "D", 0, 1), ("D", "I", "", 1, 1),
    ("I", "M", "I", 1, 0), ("I", "D", "I", 1, 0), ("I", "I", "I", 1, 0),
):
    for _x in _CIGAR_SETS[_a]:
        for _y in _CIGAR_SETS[_b]:
            _CIGAR_TRANSFORM[(_x, _y)] = (_c, _ad12, _ad23)


def apply_cigar_to_cigar(first_to_second: List[sw.CigOp],
                         second_to_third: List[sw.CigOp]) -> List[sw.CigOp]:
    """(reference: applyCigarToCigar, realign.go:81-118)"""
    result: List[sw.CigOp] = []
    started = [False]

    def add_op(op: str) -> None:
        if not started[0]:
            if op == "" or op == "D":
                return
            result.append((1, op))
            started[0] = True
            return
        if op == "":
            return
        if result[-1][1] == op:
            result[-1] = (result[-1][0] + 1, op)
        else:
            result.append((1, op))

    c12 = c23 = 0
    e12 = e23 = 0
    while c12 < len(first_to_second) and c23 < len(second_to_third):
        l12, o12 = first_to_second[c12]
        l23, o23 = second_to_third[c23]
        op13, ad12, ad23 = _CIGAR_TRANSFORM[(o12, o23)]
        add_op(op13)
        e12 += ad12
        e23 += ad23
        if e12 == l12:
            c12 += 1
            e12 = 0
        if e23 == l23:
            c23 += 1
            e23 = 0
    return result


def realign_reads_to_best_haplotype(likelihoods: ReadLikelihoods,
                                    haplotypes: List[Haplotype]) -> None:
    """(reference: realignReadsToTheirBestHaplotype, realign.go:268-396)"""
    ref_haplotype = next((h for h in haplotypes if h.is_ref), None)
    for r in range(len(likelihoods.alns)):
        aln = likelihoods.alns[r]
        best_h = second_h = None
        best_l = second_l = float("-inf")
        for hi, h in enumerate(haplotypes):
            lv = likelihoods.values[hi][r]
            if lv > best_l:
                second_h, second_l = best_h, best_l
                best_h, best_l = h, lv
            elif lv > second_l:
                second_h, second_l = h, lv
        if best_l - second_l < LOG10_INFORMATIVE_THRESHOLD:
            best_p = haplotype_priority(best_h)
            second_p = haplotype_priority(second_h)
            for hi, h in enumerate(haplotypes):
                if best_h is h:
                    continue
                lv = likelihoods.values[hi][r]
                if best_l - lv > LOG10_INFORMATIVE_THRESHOLD:
                    continue
                p = haplotype_priority(h)
                if p > best_p:
                    second_h, second_p = best_h, best_p
                    best_h, best_p = h, p
                elif p > second_p:
                    second_h, second_p = h, p
        with trace.counting("hc.sw"):
            cigar, alignment_offset = sw.run_smith_waterman(
                best_h.bases, aln.seq, *sw.REALIGN_SW_PARAMS, sw.SOFTCLIP)
        if alignment_offset < 0:
            continue
        if best_h.cigar[-1][1] == "M":
            hap_cigar = list(best_h.cigar)
            hap_cigar[-1] = (hap_cigar[-1][0] + 1000, "M")
        else:
            hap_cigar = list(best_h.cigar) + [(1000, "M")]
        hap_offset = ref_offset = 0
        for ln, op in hap_cigar:
            if op in "M=X":
                if hap_offset >= alignment_offset:
                    break
                hap_offset += ln
                ref_offset += ln
                if hap_offset > alignment_offset:
                    delta = hap_offset - alignment_offset
                    hap_offset -= delta
                    ref_offset -= delta
                    break
            elif op in "IS":
                hap_offset += ln
            elif op == "D":
                ref_offset += ln
        read_start_on_haplotype = ref_offset
        read_start_on_reference = best_h.location + ref_offset
        hap_read_len = sw.read_length(hap_cigar)
        hap_to_ref: List[sw.CigOp] = []
        pos = 0
        for ln, op in hap_cigar:
            if op == "D":
                if pos >= alignment_offset:
                    hap_to_ref.append((ln, op))
            else:
                length = min(pos + ln, hap_read_len) - max(pos, alignment_offset)
                if length > 0:
                    hap_to_ref.append((length, op))
                pos += ln
        merged: List[sw.CigOp] = []
        for ln, op in hap_to_ref:
            if merged and merged[-1][1] == op:
                merged[-1] = (merged[-1][0] + ln, op)
            else:
                merged.append((ln, op))
        hap_to_ref = merged
        read_to_ref_clean = apply_cigar_to_cigar(cigar, hap_to_ref)
        read_to_ref = sw.left_align_indel(read_to_ref_clean, ref_haplotype.bases,
                                          aln.seq, read_start_on_haplotype, 0, True)
        leading_deletions = (sw.reference_length(read_to_ref_clean)
                             - sw.reference_length(read_to_ref))
        new_aln = ClipRead(flag=aln.flag, pos=read_start_on_reference + leading_deletions,
                           pnext=aln.pnext, tlen=aln.tlen, mapq=aln.mapq,
                           cigar=list(read_to_ref), seq=aln.seq, qual=aln.qual,
                           rname=aln.rname, rnext=aln.rnext, qname=aln.qname,
                           row=aln.row)
        if aln.cigar[0][1] == "H":
            new_aln.cigar = [aln.cigar[0]] + new_aln.cigar
        if aln.cigar[-1][1] == "H":
            new_aln.cigar = new_aln.cigar + [aln.cigar[-1]]
        likelihoods.alns[r] = new_aln


# ---------------------------------------------------------------------------
# Helper: reverse trim + genotype format (assigngls.go:2180-2231)
# ---------------------------------------------------------------------------


def reverse_trim_alleles(call: Variant) -> None:
    trim = len(call.ref) - 1
    if trim < 1:
        return
    for a in call.alt:
        if is_symbolic_allele(a):
            continue
        for i in range(trim + 1):
            if i == len(a):
                trim = i - 1
                break
            if a[len(a) - i - 1] != call.ref[len(call.ref) - i - 1]:
                trim = i
                break
        if trim < 1:
            return
    call.ref = call.ref[: len(call.ref) - trim]
    call.alt = [a if is_symbolic_allele(a) else a[: len(a) - trim] for a in call.alt]


def compute_genotype_format(call: Variant) -> None:
    call.info = dict(sorted(call.info.items()))
    gd = call.genotypes[0]
    gd.data = dict(sorted(gd.data.items()))
    call.genotype_format = ["GT"] + list(gd.data.keys())


def compute_read_allele_likelihoods_for_annotation(
        params: HCParams, call: Variant,
        allele_likelihoods: ReadAlleleLikelihoods,
        filtered_alns: List[ClipRead]) -> ReadAlleleLikelihoods:
    """(reference: computeReadAlleleLikelihoodsForAnnotation,
    assigngls.go:2147-2178)"""
    cstart = call.pos
    cend = call.end()
    i = 0
    while i < len(allele_likelihoods.alns):
        aln = allele_likelihoods.alns[i]
        rstart, rend = aln.pos, read_end(aln)
        if (rstart <= cstart <= rend) or (rstart <= cend <= rend) or (rstart >= cstart and rend <= cend):
            i += 1
        else:
            del allele_likelihoods.alns[i]
            for a in allele_likelihoods.alleles:
                del allele_likelihoods.values[a][i]
    if len(allele_likelihoods.alleles) != len(call.alt) + 1:
        update_non_ref(allele_likelihoods, call.ref, call.alt)
    for aln in filtered_alns:
        rstart, rend = aln.pos, read_end(aln)
        if rstart <= cend and cstart <= rend:
            allele_likelihoods.alns.append(aln)
            for a in allele_likelihoods.alleles:
                allele_likelihoods.values[a].append(0.0)
    return allele_likelihoods


# ---------------------------------------------------------------------------
# assignGenotypeLikelihoods (assigngls.go:2233-2308)
# ---------------------------------------------------------------------------


def decompose_haplotypes_into_variants(haplotypes: List[Haplotype], contig: str,
                                       reference: bytes) -> List[int]:
    start_positions = set()
    for i, h in enumerate(haplotypes):
        h.events = make_event_map("HC%d" % i, contig, h, reference)
        for vc in h.events:
            start_positions.add(vc.pos)
    return sorted(start_positions)


def assign_genotype_likelihoods(params: HCParams, region, filtered_alns: List[ClipRead],
                                haplotypes: List[Haplotype],
                                likelihoods: ReadLikelihoods,
                                deletions: DeletionsHandler
                                ) -> Tuple[List[Variant], List[Haplotype]]:
    """(reference: assignGenotypeLikelihoods, assigngls.go:2233-2308)"""
    start_positions = decompose_haplotypes_into_variants(
        haplotypes, region.contig, region.reference)
    called_haplotypes: List[Haplotype] = []
    called_set = set()
    return_calls: List[Variant] = []
    contains_calls = False
    for loc in start_positions:
        if loc < region.start or loc > region.end:
            continue
        overlaps = get_overlapping_events(loc, haplotypes)
        events = compute_active_variant_contexts(loc, haplotypes, overlaps,
                                                 region.reference)
        if not events:
            continue
        merged = make_merged_variant(events)
        mapper = create_allele_mapper(merged, haplotypes, overlaps, loc)
        if len(mapper.alleles) > MAX_ACCEPTABLE_ALLELE_COUNT:
            reduce_alt_alleles(merged, mapper, haplotypes)
        allele_likelihoods = marginalize(
            likelihoods, mapper, max(merged.pos - 2, 1),
            min(merged.end() + 2, region.contig_length))
        if params.confidence_mode != "NONE":
            merged.alt = merged.alt + [NON_REF]
            allele_likelihoods.alleles.append(NON_REF)
            update_non_ref(allele_likelihoods, allele_likelihoods.alleles[0],
                           allele_likelihoods.alleles[1:])
        gls, pls = calculate_genotype_likelihoods(merged, allele_likelihoods)
        call, out_gls = calculate_genotypes(params, merged, pls, gls, deletions)
        if call is not None:
            if not contains_calls:
                contains_calls = any(g >= 0 for g in call.genotypes[0].gt)
            allele_likelihoods = compute_read_allele_likelihoods_for_annotation(
                params, call, allele_likelihoods, filtered_alns)
            annotate_call(params, call, allele_likelihoods, out_gls)
            if call.alt and len(call.alt) != len(merged.alt):
                reverse_trim_alleles(call)
            return_calls.append(call)
            for h in mapper.haplotypes.get(call.ref, []):
                if h not in called_set:
                    called_set.add(h)
                    called_haplotypes.append(haplotypes[h])
            for a in call.alt:
                for h in mapper.haplotypes.get(a, []):
                    if h not in called_set:
                        called_set.add(h)
                        called_haplotypes.append(haplotypes[h])
    if params.confidence_mode != "NONE":
        if not contains_calls:
            return [], []
        hmap = construct_haplotype_mapping(return_calls, called_haplotypes)
        mapping, counter_end = construct_phase_set_mapping(
            return_calls, hmap, len(called_haplotypes) - 1)
        construct_phase_groups(return_calls, mapping, counter_end)
    return return_calls, called_haplotypes
