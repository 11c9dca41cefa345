"""HaplotypeCaller driver: region trimming, callRegion, and CallVariants
(reference: filters/call-region.go, filters/haplotypecaller.go:445-950).

The reference runs two chained pargo pipelines (activity → regions →
calls → ordered GVCF combine → write). Here the orchestration is a host
loop over contigs and regions — regions are data-independent except for
the deletions side info, which flows sequentially exactly as the
reference's side channel would deliver it; the heavy per-region math
(PairHMM) dispatches to the batched device kernel.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.header import Header
from ..io import vcf as vcfmod
from ..io.vcf import FormatInformation, MetaInformation, Variant, VcfHeader
from ..filters.clipping import ClipRead, hard_clip_to_region, read_length_from_cigar
from .. import trace
from ..ops import pairhmm, sw
from . import tables
from .activity import (
    AssemblyRegion,
    HCParams,
    aln_slice,
    band_pass_states,
    compute_activity,
    compute_assembly_regions,
    downsample,
    filter_non_passing_reads,
    finalize_assembly_region,
    max_reference_length,
    read_end,
    read_overlaps_region,
)
from .assembly import Haplotype, assemble_reads
from .genotyping import (
    NON_REF,
    DeletionsHandler,
    ReadLikelihoods,
    assign_genotype_likelihoods,
    compute_genotype_format,
    formatf,
    make_event_map,
    realign_reads_to_best_haplotype,
)
from .readblock import ContigReadBlock, aln_slice_block, downsample_block
from .refconf import (
    RefBlockBatch,
    RefRun,
    SingleVariant,
    VariantCombiner,
    calculate_ref_confidence,
    concat_ref_runs,
    native_ref_model_for_no_variation,
    reference_model_for_no_variation,
    reference_variant_to_full,
)


def _print_assembly_regions(region_file, activity_file, regions) -> None:
    """IGV-format traces (reference: printAssemblyRegions,
    haploutils.go:456-479)."""
    for region in regions:
        if region_file is not None:
            region_file.write("%s\t%d\t%d\tend-marker\t0.00000\n"
                              % (region.contig, region.start - 1, region.start))
            activity = 1.0 if region.is_active else -1.0
            region_file.write("%s\t%d\t%d\tsize=%d\t%.5f\n"
                              % (region.contig, region.start - 1, region.end,
                                 region.end - region.start + 1, activity))
        if activity_file is not None and region.supporting_states is not None:
            for index, state in enumerate(region.supporting_states):
                activity_file.write("%s\t%d\t%d\tstate\t%.5f\n"
                                    % (region.contig, region.start - 1 + index,
                                       region.start + index, min(state, 1.0)))
            region.supporting_states = None


@dataclass
class TrimmingResult:
    needs_trimming: bool = False
    left_flank_start: int = 0
    left_flank_end: int = 0
    right_flank_start: int = 0
    right_flank_end: int = 0
    extended_span_start: int = 0
    extended_span_end: int = 0
    callable_span_start: int = 0
    callable_span_end: int = 0


def trim(params: HCParams, region: AssemblyRegion,
         variation_events: Dict[int, Variant]) -> TrimmingResult:
    """(reference: trim, call-region.go:41-133)"""
    if not variation_events:
        return TrimmingResult(needs_trimming=False, left_flank_start=region.start,
                              left_flank_end=region.end)
    span_start = 2 ** 31 - 1
    span_end = -(2 ** 31)
    within = 0
    found_non_snp = False
    for vc in variation_events.values():
        if vc.pos <= region.end:
            end = vc.end()
            if end >= region.start:
                if not found_non_snp:
                    if len(vc.ref) != 1:
                        found_non_snp = True
                    else:
                        for a in vc.alt:
                            if len(a) != 1:
                                found_non_snp = True
                                break
                span_start = min(span_start, vc.pos)
                span_end = max(span_end, end)
                within += 1
    if within == 0:
        return TrimmingResult(needs_trimming=False, left_flank_start=region.start,
                              left_flank_end=region.end)
    padding = 150 if found_non_snp else 20
    maximum_start = max(region.start - 25, 1)
    maximum_end = min(region.end + 25, region.contig_length)
    ideal_start = max(span_start - padding, 1)
    ideal_end = min(span_end + padding, region.contig_length)
    final_start = min(max(maximum_start, ideal_start), span_start)
    final_end = max(min(maximum_end, ideal_end), span_end)
    if params.confidence_mode == "NONE":
        callable_start = span_start
        callable_end = span_end
    else:
        callable_start = max(span_start, region.start)
        callable_end = min(span_end, region.end)
    left_start = left_end = right_start = right_end = 0
    if region.start < callable_start:
        left_start = region.start
        left_end = callable_start - 1
    if region.end > callable_end:
        right_start = callable_end + 1
        right_end = region.end
    return TrimmingResult(
        needs_trimming=True,
        left_flank_start=left_start, left_flank_end=left_end,
        right_flank_start=right_start, right_flank_end=right_end,
        extended_span_start=final_start, extended_span_end=final_end,
        callable_span_start=span_start, callable_span_end=span_end,
    )


def _coordinate_sort_key(r: ClipRead):
    flag = r.flag
    return (r.pos, (flag & 0x10) != 0, r.qname, flag, r.mapq, r.pnext, r.tlen)


def trim_region(region: AssemblyRegion, span_start: int, span_end: int,
                extended_start: int, extended_end: int) -> AssemblyRegion:
    """(reference: trimRegion, call-region.go:135-166)"""
    sub_start = max(region.start, span_start)
    sub_end = min(region.end, span_end)
    required_right = max(extended_end - sub_end, 0)
    required_left = max(sub_start - extended_start, 0)
    required_extension = min(max(required_left, required_right), region.extension)
    result = AssemblyRegion(
        contig=region.contig, reference=region.reference,
        start=sub_start, end=sub_end, extension=required_extension,
        contig_length=region.contig_length, is_active=region.is_active,
    )
    loc_start = result.padded_start()
    loc_end = result.padded_end()
    trimmed: List[ClipRead] = []
    for aln in region.reads:
        r = ClipRead(flag=aln.flag, pos=aln.pos, pnext=aln.pnext, tlen=aln.tlen,
                     mapq=aln.mapq, cigar=list(aln.cigar), seq=aln.seq,
                     qual=aln.qual, rname=aln.rname, rnext=aln.rnext,
                     qname=aln.qname, row=aln.row)
        hard_clip_to_region(r, loc_start, loc_end)
        if read_overlaps_region(r, loc_start, loc_end):
            trimmed.append(r)
    trimmed.sort(key=_coordinate_sort_key)
    result.reads = trimmed
    return result


def trim_region1(region: AssemblyRegion, span_start: int, span_end: int,
                 extension: int) -> AssemblyRegion:
    extended_start = max(1, span_start - extension)
    extended_end = min(span_end + extension, region.contig_length)
    return trim_region(region, span_start, span_end, extended_start, extended_end)


def trim_haplotype(h: Haplotype, span_start: int, span_end: int) -> Optional[Haplotype]:
    """(reference: haplotype.trim, call-region.go:182-252)"""
    new_start = span_start - h.location
    new_end = span_end - h.location
    ref_pos = 0
    bases_pos = 0
    bases_start = -1
    bases_stop = -1
    for ln, op in h.cigar:
        if op == "I":
            bases_pos += ln
        elif op in "MX=":
            if ref_pos <= new_start < ref_pos + ln:
                bases_start = bases_pos + new_start - ref_pos
            if ref_pos <= new_end < ref_pos + ln:
                bases_stop = bases_pos + new_end - ref_pos
                break
            ref_pos += ln
            bases_pos += ln
        elif op == "D":
            if (ref_pos <= new_start < ref_pos + ln) or (ref_pos <= new_end < ref_pos + ln):
                return None
            ref_pos += ln
    if bases_start < 0 or bases_stop < 0:
        return None
    new_bases = h.bases[bases_start : bases_stop + 1]
    new_cigar: List[sw.CigOp] = []
    pos = 0
    for ln, op in h.cigar:
        if pos > new_end:
            break
        if op in "MX=D":
            length = min(pos + ln - 1, new_end) - max(pos, new_start) + 1
            if length > 0:
                new_cigar.append((length, op))
            pos += ln
        elif op in "SI":
            if pos >= new_start:
                new_cigar.append((ln, op))
    if not new_cigar:
        return None
    if new_cigar[0][1] in "ID" or new_cigar[-1][1] in "ID":
        return None
    merged: List[sw.CigOp] = []
    i = 0
    # replicate the reference's skip-by-two merge quirk (call-region.go:243-250)
    nc = list(new_cigar)
    i = 1
    while i < len(nc):
        if nc[i - 1][1] == nc[i][1]:
            nc[i - 1] = (nc[i - 1][0] + nc[i][0], nc[i][1])
            del nc[i]
            i += 1
        else:
            i += 2
    return Haplotype(bases=new_bases, location=span_start, cigar=nc,
                     is_ref=h.is_ref, score=h.score)


# ---------------------------------------------------------------------------
# callRegion (call-region.go:254-426)
# ---------------------------------------------------------------------------


class _CombinerPump:
    """Ordered combine/sink stage on its own thread.

    The reference runs the GVCF variant combiner as a StrictOrd pipeline
    stage concurrent with callRegion workers (haplotypecaller.go:907-944);
    here the analogous decoupling puts the combiner on one thread fed by
    a bounded queue so the main thread keeps polling worker results and
    pre-starting the next span while runs merge/format/compress. A
    single consumer preserves the strict region order. Errors are
    sticky: the first failure re-raises on the next put/close."""

    def __init__(self, combine_batch, flush_runs_batch, max_queue: int = 64):
        import queue
        import threading

        self._combine = combine_batch
        self._flush = flush_runs_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._exc: Optional[BaseException] = None
        self._tb = None
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="hc-combiner")
        self._t.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # drain without combining after a failure
            try:
                with trace.span("hc.combine"):
                    if item[0] == "flush":
                        self._flush()
                    else:
                        self._combine(item[1], item[2], item[3])
            except BaseException as e:
                self._tb = e.__traceback__
                self._exc = e

    def check(self) -> None:
        """Raise the sticky failure (callable from any polling loop).

        Re-raising resets the traceback to its capture-time snapshot so
        repeated checks do not accrete raise-site frames."""
        if self._exc is not None:
            raise self._exc.with_traceback(self._tb)

    def put_batch(self, contig, reference, region_variants) -> None:
        self.check()
        self._q.put(("batch", contig, reference, region_variants))

    def put_flush(self) -> None:
        self.check()
        self._q.put(("flush",))

    def close(self) -> None:
        """Drain, join, and re-raise any pump failure. After close the
        caller may touch the pump-owned state directly (the thread is
        gone; the join gives the happens-before edge)."""
        self._q.put(None)
        self._t.join()
        self.check()


class PendingRegion:
    """A region that passed assembly/trimming and awaits PairHMM +
    genotyping (the device stage between prepare_region and
    genotype_region — pairs from many pendings share one dispatch)."""

    __slots__ = ("region", "region_for_genotyping", "trimming", "haplotypes",
                 "filtered_reads", "reads_in", "hap_bases", "hap_is_ref")

    def __init__(self, region, region_for_genotyping, trimming, haplotypes,
                 filtered_reads, reads_in, hap_bases, hap_is_ref):
        self.region = region
        self.region_for_genotyping = region_for_genotyping
        self.trimming = trimming
        self.haplotypes = haplotypes
        self.filtered_reads = filtered_reads
        self.reads_in = reads_in
        self.hap_bases = hap_bases
        self.hap_is_ref = hap_is_ref


def prepare_region(params: HCParams, region: AssemblyRegion,
                   preclip: "dict | None" = None,
                   span_cols: "dict | None" = None,
                   span_rows: "np.ndarray | None" = None,
                   span_reference: bytes = b"",
                   fill_reads=None,
                   ) -> Tuple[Optional[List[SingleVariant]],
                              Optional[PendingRegion]]:
    """Host stage of call_region up to the PairHMM inputs: finalize,
    assemble, trim. Returns (terminal_variants, None) when the region
    exits through the reference model (deletions flow through
    unchanged), else (None, pending). ``preclip`` forwards to
    finalize_assembly_region (native per-block pre-clipping).
    ``span_cols``/``span_rows``/``span_reference`` (the worker block's
    columnar post-preclip arrays plus this region's candidate row
    indices) enable the native one-call ref model on no-variation
    regions and the native columnar finalize feeding assembly
    (hc/refconf.py and activity.finalize_assembly_region are the
    oracles). ``fill_reads(region)`` lazily materializes region.reads —
    with the columnar fast paths most active regions never build
    Python read objects at all."""
    gvcf = params.confidence_mode != "NONE"
    variants: List[SingleVariant] = []
    reads_ready = fill_reads is None

    def ensure_reads():
        nonlocal reads_ready
        if not reads_ready:
            fill_reads(region)
            reads_ready = True

    def ref_model_exit(target_region: AssemblyRegion, finalized: bool = True):
        """Every no-variation exit — inactive regions AND active regions
        whose assembly/trim found no variation events — goes through the
        native one-call columnar ref model when the block columns are
        available (it recomputes finalize internally from the raw rows,
        so the region's Python-finalized reads are bypassed; oracle:
        finalize_assembly_region + reference_model_for_no_variation,
        fuzz-pinned). Profiled at 1M reads, these exits were 97% of
        active-region prepares and the Python path burned ~27 core-s in
        finalize+refconf."""
        if params.confidence_mode == "NONE":
            return variants, None
        if span_cols is not None and span_rows is not None:
            got = native_ref_model_for_no_variation(
                params, variants, target_region, span_cols, span_rows,
                span_reference)
            if got is not None:
                return got, None
        if not finalized:
            ensure_reads()
            finalize_assembly_region(target_region, params, preclip)
        reference_model_for_no_variation(params, variants, target_region, gvcf)
        return variants, None

    if span_rows is not None:
        no_candidates = len(span_rows) == 0
    else:
        ensure_reads()
        no_candidates = not region.reads
    if not region.is_active or no_candidates:
        if params.confidence_mode == "NONE":
            return variants, None
        return ref_model_exit(region, finalized=False)

    # columnar finalize: the assembly input (sorted, region-clipped,
    # pair-reconciled seq/qual) comes straight from the block columns in
    # one native call — most active regions never materialize Python
    # read objects (oracle: finalize_assembly_region + the list
    # comprehension below; fuzz-pinned byte-equal in
    # tests/test_refconf_native.py::test_finalize_region_seq_quals_matches_python)
    finalized = False
    reads_sq = None
    if span_cols is not None and span_rows is not None and \
            not os.environ.get("ELPREP_TPU_NO_NATIVE_FINALIZE"):
        from .. import native

        fin = native.finalize_region_seq_quals(
            span_rows, span_cols, region.padded_start(), region.padded_end())
        if fin is not None:
            offs, seq_c, qual_c = fin
            # columnar handoff: assemble_reads/assembly_try consume the
            # flat arrays directly; per-read bytes pairs materialize only
            # on the Python-oracle fallback inside assemble_reads
            reads_sq = (seq_c, qual_c, offs)
    if reads_sq is None:
        ensure_reads()
        finalize_assembly_region(region, params, preclip)
        finalized = True
        reads_sq = [(r.seq, r.qual) for r in region.reads]

    haplotypes = assemble_reads(
        region.reference_bases(), region.padded_start(), reads_sq,
        min_base_qual=params.min_base_qual,
    )

    variation_events: Dict[int, Variant] = {}
    for i, h in enumerate(haplotypes):
        events = make_event_map("HC%d" % i, region.contig, h, region.reference)
        h.events = events
        for vc in events:
            variation_events[vc.pos] = vc

    trimming = trim(params, region, variation_events)
    if not trimming.needs_trimming:
        return ref_model_exit(region, finalized=finalized)
    if not finalized:
        # the genotyping path consumes region.reads (trim_region, flank
        # ref models): run the Python finalize now — semantics identical
        # to the native one above (fuzz-pinned)
        ensure_reads()
        finalize_assembly_region(region, params, preclip)
        finalized = True

    if params.confidence_mode == "NONE":
        region_for_genotyping = trim_region(
            region, trimming.extended_span_start, trimming.extended_span_end,
            trimming.extended_span_start, trimming.extended_span_end)
    else:
        region_for_genotyping = trim_region(
            region, trimming.callable_span_start, trimming.callable_span_end,
            trimming.extended_span_start, trimming.extended_span_end)

    trimmed_haplotypes: List[Haplotype] = []
    for h in haplotypes:
        th = trim_haplotype(h, region_for_genotyping.padded_start(),
                            region_for_genotyping.padded_end())
        if th is None:
            continue
        dup = False
        for i, existing in enumerate(trimmed_haplotypes):
            if th.bases == existing.bases:
                if th.is_ref:
                    trimmed_haplotypes[i] = th
                dup = True
                break
        if not dup:
            trimmed_haplotypes.append(th)
    trimmed_haplotypes.sort(key=lambda h: (len(h.bases), h.bases))
    haplotypes = trimmed_haplotypes
    variation_present = any(not h.is_ref for h in haplotypes)
    if not variation_present:
        return ref_model_exit(region)

    region_for_genotyping.reads = [
        r for r in region_for_genotyping.reads if len(r.seq) >= 10
    ]
    filtered_reads = filter_non_passing_reads(region_for_genotyping)
    if not region_for_genotyping.reads:
        return ref_model_exit(region)

    reads_in = [(r.seq, np.frombuffer(r.qual, np.uint8), r.mapq)
                for r in region_for_genotyping.reads]
    hap_bases = [h.bases for h in haplotypes]
    hap_is_ref = [h.is_ref for h in haplotypes]
    return None, PendingRegion(region, region_for_genotyping, trimming,
                               haplotypes, filtered_reads, reads_in,
                               hap_bases, hap_is_ref)


def genotype_region(params: HCParams, pending: PendingRegion,
                    vals: np.ndarray, keep: np.ndarray,
                    incoming_deletions: List[Tuple[int, int]]
                    ) -> Tuple[List[SingleVariant], List[Tuple[int, int]]]:
    """Second stage of call_region: consume precomputed PairHMM
    likelihoods, genotype, and emit variants + outgoing deletions."""
    deletions = DeletionsHandler(incoming_deletions)
    variants = _genotype(params, pending, vals, keep, deletions)
    return variants, deletions.slice


def genotype_region_speculative(params: HCParams, pending: PendingRegion,
                                vals: np.ndarray, keep: np.ndarray
                                ) -> Tuple[List[SingleVariant],
                                           List[Tuple[int, int]], bool]:
    """genotype_region under an assumed-empty incoming deletions carry,
    for a pool worker that cannot know the true one yet: (variants,
    outgoing, consulted). Where ``consulted`` is false genotyping never
    read the carry, so under a true incoming carry ``c`` the variants
    are the same and the outgoing carry is ``c + outgoing``."""
    deletions = DeletionsHandler([])
    variants = _genotype(params, pending, vals, keep, deletions)
    return variants, deletions.slice, deletions.consulted


def _genotype(params: HCParams, pending: PendingRegion, vals: np.ndarray,
              keep: np.ndarray, deletions: DeletionsHandler
              ) -> List[SingleVariant]:
    gvcf = params.confidence_mode != "NONE"
    variants: List[SingleVariant] = []
    region = pending.region
    region_for_genotyping = pending.region_for_genotyping
    trimming = pending.trimming
    haplotypes = pending.haplotypes
    filtered_reads = pending.filtered_reads

    kept_alns = [r for r, k in zip(region_for_genotyping.reads, keep) if k]
    likelihoods = ReadLikelihoods(haps=haplotypes, alns=kept_alns, values=vals)

    realign_reads_to_best_haplotype(likelihoods, haplotypes)
    return_calls, _called = assign_genotype_likelihoods(
        params, region_for_genotyping, filtered_reads, haplotypes, likelihoods,
        deletions)

    if not return_calls:
        if gvcf:
            reference_model_for_no_variation(params, variants, region, gvcf)
        return variants

    if not gvcf:
        for call in return_calls:
            raw = call.info.pop("RAW_MQandDP", None)
            if raw is not None:
                ssum, depth = raw
                rms = math.sqrt(ssum / depth)
                call.info["MQ"] = formatf(rms, 2)
            compute_genotype_format(call)
        variants.extend(SingleVariant(full_variant=c) for c in return_calls)
        return variants

    for call in return_calls:
        compute_genotype_format(call)

    if trimming.left_flank_end >= trimming.left_flank_start:
        reference_model_for_no_variation(
            params, variants,
            trim_region1(region, trimming.left_flank_start, trimming.left_flank_end,
                         region.extension), gvcf)
    calculate_ref_confidence(params, variants, region_for_genotyping,
                             likelihoods.alns, return_calls, gvcf,
                             as_runs=params.confidence_mode == "GVCF")
    if trimming.right_flank_end >= trimming.right_flank_start:
        reference_model_for_no_variation(
            params, variants,
            trim_region1(region, trimming.right_flank_start, trimming.right_flank_end,
                         region.extension), gvcf)
    return variants


def call_region(params: HCParams, region: AssemblyRegion,
                incoming_deletions: List[Tuple[int, int]],
                use_device_pairhmm: bool = True
                ) -> Tuple[List[SingleVariant], List[Tuple[int, int]]]:
    """Single-region prepare + PairHMM + genotype (reference:
    callRegion, call-region.go:254-426). call_variants batches the
    PairHMM stage across regions instead of calling this directly."""
    terminal, pending = prepare_region(params, region)
    if pending is None:
        return terminal, incoming_deletions
    vals, keep = pairhmm.compute_read_likelihoods(
        pending.reads_in, pending.hap_bases, pending.hap_is_ref,
        use_device=use_device_pairhmm)
    return genotype_region(params, pending, vals, keep, incoming_deletions)


# ---------------------------------------------------------------------------
# VCF header (haplotypecaller.go:445-674)
# ---------------------------------------------------------------------------

PROGRAM_NAME = "elprep_tpu"
PROGRAM_VERSION = "5.1.3"
PROGRAM_URL = "https://github.com/exascience/elprep"


def write_vcf_header(params: HCParams, sam_header: Header, sample_name: str,
                     get_reference, now: Optional[str] = None) -> VcfHeader:
    hdr = VcfHeader(meta={})
    if now is None:
        now = time.strftime("%a %b %d %H:%M:%S %Z %Y")
    hdr.meta["elPrepCommandLine"] = [MetaInformation(
        id=PROGRAM_NAME,
        fields={"CommandLine": params.command_line, "Version": PROGRAM_VERSION,
                "URL": PROGRAM_URL, "Date": now},
    )]
    infos = [
        FormatInformation("BaseQRankSum", "Z-score from Wilcoxon rank sum test of Alt Vs. Ref base qualities", 1, "Float"),
        FormatInformation("DP", "Approximate read depth; some reads may have been filtered", 1, "Integer"),
        FormatInformation("DS", "Were any of the samples downsampled?", 0, "Flag"),
        FormatInformation("ExcessHet", "Phred-scaled p-value for exact test of excess heterozygosity", 1, "Float"),
        FormatInformation("InbreedingCoeff", "Inbreeding coefficient as estimated from the genotype likelihoods per-sample when compared against the Hardy-Weinberg expectation", 1, "Float"),
        FormatInformation("MLEAC", "Maximum likelihood expectation (MLE) for the allele counts (not necessarily the same as the AC), for each ALT allele, in the same order as listed", vcfmod.NUMBER_A, "Integer"),
        FormatInformation("MLEAF", "Maximum likelihood expectation (MLE) for the allele frequency (not necessarily the same as the AF), for each ALT allele, in the same order as listed", vcfmod.NUMBER_A, "Float"),
        FormatInformation("MQRankSum", "Z-score From Wilcoxon rank sum test of Alt vs. Ref read mapping qualities", 1, "Float"),
        FormatInformation("ReadPosRankSum", "Z-score from Wilcoxon rank sum test of Alt vs. Ref read position bias", 1, "Float"),
    ]
    formats = [
        FormatInformation("AD", "Allelic depths for the ref and alt alleles in the order listed", vcfmod.NUMBER_R, "Integer"),
        FormatInformation("DP", "Approximate read depth (reads with MQ=255 or with bad mates are filtered)", 1, "Integer"),
        FormatInformation("GQ", "Genotype Quality", 1, "Integer"),
        FormatInformation("GT", "Genotype", 1, "String"),
        FormatInformation("PL", "Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification", vcfmod.NUMBER_G, "Integer"),
    ]
    hdr.meta["FILTER"] = [MetaInformation(id="LowQual", description="Low quality")]
    hdr.meta["contig"] = [
        MetaInformation(id=sq["SN"], fields={"length": str(len(get_reference(sq["SN"])))})
        for sq in sam_header.sq
    ]
    hdr.meta["source"] = ["HaplotypeCaller"]
    if params.confidence_mode == "NONE":
        infos += [
            FormatInformation("AC", "Allele count in genotypes, for each ALT allele, in the same order as listed", vcfmod.NUMBER_A, "Integer"),
            FormatInformation("AF", "Allele Frequency, for each ALT allele, in the same order as listed", vcfmod.NUMBER_A, "Float"),
            FormatInformation("AN", "Total number of alleles in called genotypes", 1, "Integer"),
            FormatInformation("FS", "Phred-scaled p-value using Fisher's exact test to detect strand bias", 1, "Float"),
            FormatInformation("MQ", "RMS Mapping Quality", 1, "Float"),
            FormatInformation("QD", "Variant Confidence/Quality by Depth", 1, "Float"),
            FormatInformation("SOR", "Symmetric Odds Ratio of 2x2 contingency table to detect strand bias", 1, "Float"),
        ]
    else:
        infos.append(FormatInformation("RAW_MQandDP", "Raw data (sum of squared MQ and total depth) for improved RMS Mapping Quality calculation. Incompatible with deprecated RAW_MQ formulation.", 2, "Integer"))
        formats += [
            FormatInformation("PGT", "Physical phasing haplotype information, describing how the alternate alleles are phased in relation to one another", 1, "String"),
            FormatInformation("PID", "Physical phasing ID information, where each unique ID within a given sample (but not across samples) connects records within a phasing group", 1, "String"),
            FormatInformation("PS", "Phasing set (typically the position of the first variant in the set)", 1, "Integer"),
            FormatInformation("SB", "Per-sample component statistics which comprise the Fisher's Exact Test to detect strand bias.", 4, "Integer"),
        ]
        hdr.meta["ALT"] = [MetaInformation(id="NON_REF", description="Represents any possible alternative allele at this location")]
        if params.confidence_mode == "GVCF":
            infos.append(FormatInformation("END", "Stop position of the interval", 1, "Integer"))
            formats.append(FormatInformation("MIN_DP", "Minimum DP observed within the GVCF block", 1, "Integer"))
            for i in range(1, len(params.gq_bands)):
                mn, mx = params.gq_bands[i - 1], params.gq_bands[i]
                hdr.meta["GVCFBlock%d-%d" % (mn, mx)] = [
                    "minGQ=%d(inclusive),maxGQ=%d(exclusive)" % (mn, mx)]
    hdr.formats = sorted(formats, key=lambda f: f.id)
    hdr.infos = sorted(infos, key=lambda f: f.id)
    hdr.columns = list(vcfmod.DEFAULT_COLUMNS) + ["FORMAT", sample_name]
    return hdr


# ---------------------------------------------------------------------------
# CallVariants (haplotypecaller.go:677-950)
# ---------------------------------------------------------------------------


# records (not list items) buffered before a streaming-sink flush:
# ~64k records is ~4 MB of GVCF text per sink batch — large enough to
# amortize the native formatter/deflate, small enough that the sink
# thread streams alongside region consumption (flush boundaries do not
# change output bytes; BGZF blocks chop at fixed 64 KB regardless)
_SINK_FLUSH_RECORDS = int(os.environ.get("ELPREP_TPU_VCF_FLUSH_RECORDS",
                                         "65536"))
# positions buffered as adjacent RefRuns before a vectorized merge_run
# (the combiner's batch granularity; also bounds buffered memory)
_RUN_BUF_POSITIONS = 1 << 17


def _iter_region_results_serial(params, regions, deletions, use_device_pairhmm,
                                fill_reads):
    """Yield (region, variants, deletions) in order — single-process
    version of the pool's region runs. Regions are prepared
    (assembled/trimmed) in groups so all their PairHMM pairs share ONE
    device dispatch; genotyping then runs in order (the deletions side
    channel is serial, reference: side-channel.go:26-132)."""
    GROUP = 16
    for g0 in range(0, len(regions), GROUP):
        group = regions[g0 : g0 + GROUP]
        prepared = []
        for region in group:
            fill_reads(region)
            prepared.append(prepare_region(params, region))
        pendings = [p for _, p in prepared if p is not None]
        likelihood_pairs = pairhmm.compute_read_likelihoods_multi(
            [(p.reads_in, p.hap_bases, p.hap_is_ref) for p in pendings],
            use_device=use_device_pairhmm)
        results = iter(likelihood_pairs)
        for region, (terminal, pending) in zip(group, prepared):
            if pending is None:
                yield region, terminal, deletions
            else:
                vals, keep = next(results)
                variants, deletions = genotype_region(
                    params, pending, vals, keep, deletions)
                yield region, variants, deletions


def call_variants(
    params: HCParams,
    sam_header: Header,
    reads_by_contig: Dict[str, List[ClipRead]],
    get_reference,
    sample_name: str = "",
    bed_regions: Optional[Dict[str, List[Tuple[int, int]]]] = None,
    use_device_pairhmm: bool = True,
    now: Optional[str] = None,
    activity_profile=None,
    assembly_regions_out=None,
    nr_workers: int = 1,
    variant_sink=None,
    restrict_contigs: Optional[set] = None,
) -> Tuple[VcfHeader, List[Variant]]:
    """Run the full HaplotypeCaller over coordinate-sorted reads.

    ``reads_by_contig`` maps contig name -> coordinate-sorted ClipReads;
    ``get_reference(contig) -> bytes`` supplies the (upper/N-normalized)
    reference sequence. ``restrict_contigs`` limits calling (including
    the zero-coverage GVCF bands) to the named contigs — the multi-host
    contig-partition hook (parallel/multihost.py); None means all header
    contigs. Returns (vcf header, variants)."""
    vcf_header = write_vcf_header(params, sam_header, sample_name, get_reference, now)
    if assembly_regions_out is not None:
        assembly_regions_out.write("#track graphType=line\n")
        assembly_regions_out.write("Chromosome\tStart\tEnd\tFeature\tAssemblyRegions\n")
    if activity_profile is not None:
        activity_profile.write("#track graphType=line\n")
        activity_profile.write("Chromosome\tStart\tEnd\tFeature\tActivityProfile\n")
    gvcf = params.confidence_mode == "GVCF"
    combiner = VariantCombiner(params, get_reference) if gvcf else None
    out_variants: List[Variant] = []
    run_buf: List = []
    run_len = 0
    # records (not items) currently buffered in out_variants — kept
    # incrementally (the combiner only ever APPENDS to the list) so the
    # sink-flush check below is O(new items), not a rescan of the whole
    # list per region batch (quadratic in non-GVCF mode, where every
    # record is its own item)
    sink_records = 0

    def flush_runs(variants: List[Variant]) -> List[Variant]:
        nonlocal run_len
        if run_buf:
            variants = combiner.merge_run(variants, concat_ref_runs(run_buf))
            run_buf.clear()
            run_len = 0
        return variants

    from .parallel import get_pool

    pool = get_pool(nr_workers)

    # split files restrict calling to their @cs contigs — other contigs
    # produce nothing, not even reference blocks
    # (reference: CallVariants validContigs, haplotypecaller.go:678-744)
    cs = sam_header.contigs()
    valid_contigs = set(cs) if cs else None

    def _iter_units():
        """Yield one work unit per (contig, span): the per-contig
        downsampling/reference/position prep runs lazily the first time
        a contig's unit is pulled — which, with the pool's lookahead,
        happens while the PREVIOUS span is still draining."""
        for sq in sam_header.sq:
            contig = sq["SN"]
            if valid_contigs is not None and contig not in valid_contigs:
                continue
            if restrict_contigs is not None and contig not in restrict_contigs:
                continue
            contig_length = sam_header.sq_ln(sq)
            contig_src = reads_by_contig.get(contig, [])
            block: Optional[ContigReadBlock] = None
            if isinstance(contig_src, ContigReadBlock):
                block = downsample_block(contig_src, params)
                if pool is None:
                    # serial path consumes ClipReads directly
                    contig_reads = block.materialize()
                    block = None
                else:
                    contig_reads = None
            else:
                contig_reads = downsample(contig_src, params)
            reference = get_reference(contig)
            if bed_regions is not None:
                spans = bed_regions.get(contig)
                if not spans:
                    continue
            else:
                spans = [(0, contig_length)]
            if block is not None:
                max_ref_len = block.max_reference_length()
                contig_positions = block.pos
            else:
                max_ref_len = max_reference_length(contig_reads)
                contig_positions = np.fromiter((r.pos for r in contig_reads),
                                               np.int64, len(contig_reads))
            for start, stop in spans:
                padded_lo = max(0, start - params.padding)
                padded_hi = min(contig_length, stop + params.padding)
                if block is not None:
                    region_block = (aln_slice_block(block, padded_lo, padded_hi,
                                                    max_ref_len)
                                    if bed_regions is not None else block)
                    region_reads = None
                    region_positions = region_block.pos
                else:
                    region_block = None
                    region_reads, _ = aln_slice(contig_reads, padded_lo,
                                                padded_hi, max_ref_len,
                                                positions=contig_positions) \
                        if bed_regions is not None else (contig_reads, 0)
                    region_positions = (np.fromiter(
                        (r.pos for r in region_reads), np.int64,
                        len(region_reads))
                        if bed_regions is not None else contig_positions)
                yield (contig, contig_length, reference, start, stop,
                       max_ref_len, region_block, region_reads,
                       region_positions)

    def _launch(u):
        """Start a unit's worker-side stages (span creation, block
        distribution, activity scatter) — runs while the previous unit
        is still being consumed."""
        (contig, contig_length, reference, start, stop, max_ref_len,
         region_block, region_reads, region_positions) = u
        from .parallel import ACT_CHUNK

        gen = pool.new_span(params, reference, contig, contig_length,
                            ref_key=contig)
        pool.distribute_span(
            gen, region_block if region_block is not None else region_reads,
            region_positions, max_ref_len, params=params)
        bounds = [(cs, min(cs + ACT_CHUNK, stop))
                  for cs in range(start, stop, ACT_CHUNK)]
        pool.send_activity(gen, bounds)
        return gen, bounds

    current_contig: Optional[str] = None
    deletions: List[Tuple[int, int]] = []

    def _combine_batch(contig, reference, region_variants):
        """One region batch through the GVCF combiner and the streaming
        sink — runs ON THE PUMP THREAD, which owns out_variants /
        run_buf / combiner. The heavy parts (native band-block scan,
        block formatting, zlib) release the GIL, so combining overlaps
        the main thread's result polling, PairHMM dispatch, and
        cross-span pre-starts (those were measured serializing the
        span pipeline at 1M reads)."""
        nonlocal out_variants, run_len, sink_records
        pre_items = len(out_variants)
        for sv in region_variants:
            if gvcf:
                out_variants = combiner.set_contig(out_variants, contig)
                if isinstance(sv, RefRun):
                    # buffer position-adjacent runs: one vectorized
                    # merge replaces thousands of per-region calls
                    if run_buf and (run_buf[-1].pos0 + len(run_buf[-1])
                                    != sv.pos0
                                    or run_len > _RUN_BUF_POSITIONS):
                        out_variants = flush_runs(out_variants)
                    run_buf.append(sv)
                    run_len += len(sv)
                else:
                    out_variants = flush_runs(out_variants)
                    out_variants = combiner.merge_variant(out_variants, sv)
            else:
                if sv.full_variant is not None:
                    out_variants.append(sv.full_variant)
                else:
                    out_variants.append(
                        reference_variant_to_full(contig, reference, sv))
        # streaming writeback: emitted entries are final (the
        # combiner's open block is not in the list yet), so the
        # accumulated prefix can flush at any point. Count RECORDS, not
        # list items: one RefBlockBatch item holds tens of thousands of
        # reference-block records, so an item-count threshold never
        # fired at GVCF scale and ~all formatting+compression serialized
        # into sink.close (profiled ~3 s of the 1M HC phase wall) — the
        # record-count check keeps the sink thread streaming alongside
        # region consumption instead
        if variant_sink is not None:
            sink_records += sum(
                len(v) if isinstance(v, RefBlockBatch) else 1
                for v in out_variants[pre_items:])
            if sink_records >= _SINK_FLUSH_RECORDS:
                variant_sink.write_variants(out_variants)
                out_variants = []
                sink_records = 0

    def _flush_runs_batch():
        nonlocal out_variants, sink_records
        pre_items = len(out_variants)
        out_variants = flush_runs(out_variants)
        sink_records += sum(
            len(v) if isinstance(v, RefBlockBatch) else 1
            for v in out_variants[pre_items:])

    pump = _CombinerPump(_combine_batch, _flush_runs_batch)

    def _consume_unit(u, results_iter, tick=None):
        """Drive one span's ordered results into the combiner pump
        (shared by the pool and serial paths). ``tick`` runs once per
        region batch — the pool path uses it to pre-start the NEXT
        span's region run the moment its activity results have all
        arrived."""
        nonlocal deletions
        (contig, contig_length, reference, start, stop, *_rest) = u
        for _region, region_variants, deletions in results_iter:
            if tick is not None and not tick():
                tick = None  # done (or nothing to pre-start)
            pump.put_batch(contig, reference, region_variants)

    def _enter_contig(contig):
        # the run buffer must not cross a contig switch: its runs belong
        # to the combiner's current contig; the deletions carry is
        # per-contig
        nonlocal deletions, current_contig
        if contig != current_contig:
            pump.put_flush()
            deletions = []
            current_contig = contig

    def _build_regions(u, bounds, results):
        (contig, contig_length, reference, start, stop, *_rest) = u
        # activity over [start+1, stop+1) in 1-based space, chunked to
        # bound the flat pileup expansion (the reference uses
        # 512-position chunks, haplotypecaller.go:826-852)
        span = stop - start
        is_active = np.zeros(span, np.float64)
        hq_mean = np.zeros(span, np.float64)
        for (cs, ce), (ia, hm) in zip(bounds, results):
            is_active[cs - start : ce - start] = ia
            hq_mean[cs - start : ce - start] = hm
        states = band_pass_states(is_active, hq_mean, params)
        regions = compute_assembly_regions(
            contig, reference, start, stop, contig_length, states, params,
            keep_states=activity_profile is not None)
        if assembly_regions_out is not None or activity_profile is not None:
            _print_assembly_regions(assembly_regions_out, activity_profile,
                                    regions)
        return regions

    def _consume_all_units():
        if pool is not None:
            # lookahead-1 pipeline: the NEXT span's worker-side stages
            # (reference broadcast, block distribution, activity) run while
            # the CURRENT span's regions prepare/genotype/drain — matching
            # the reference's fully-overlapped pargo pipeline
            # (haplotypecaller.go:907-944) across contig boundaries too.
            # Once the next span's activity has fully arrived (buffered),
            # its regions build and its prepare tasks START mid-drain, so
            # workers roll from one span's preps straight into the next's.
            units = _iter_units()
            u0 = next(units, None)
            # launched entries: [unit, gen, bounds, prestarted_run_or_None]
            launched = None if u0 is None else [u0, *_launch(u0), None]
            while launched is not None:
                u, gen, bounds, pre = launched
                nxt = next(units, None)
                launched = None if nxt is None else [nxt, *_launch(nxt), None]

                if pre is None:
                    results = pool.collect_activity(gen)
                    regions = _build_regions(u, bounds, results)
                    run = pool.start_regions(gen, params, regions,
                                             use_device_pairhmm)
                else:
                    regions, run = pre
                _enter_contig(u[0])

                def _tick(nxt=launched):
                    # pre-start the next span once its activity is complete
                    # (region building reads only activity arrays + params;
                    # the combiner state is untouched until consumption)
                    if nxt is None or nxt[3] is not None:
                        return False
                    if not pool.activity_ready(nxt[1]):
                        return True  # keep checking
                    res2 = pool.collect_activity(nxt[1])
                    regions2 = _build_regions(nxt[0], nxt[2], res2)
                    nxt[3] = (regions2, pool.start_regions(
                        nxt[1], params, regions2, use_device_pairhmm))
                    return False

                _consume_unit(u, run.results(deletions, health=pump.check),
                              tick=_tick)
        else:
            for u in _iter_units():
                (contig, contig_length, reference, start, stop, max_ref_len,
                 region_block, region_reads, region_positions) = u
                CHUNK = 1 << 18
                bounds = [(cs, min(cs + CHUNK, stop))
                          for cs in range(start, stop, CHUNK)]
                results = [
                    compute_activity(
                        aln_slice(region_reads, cs + 1 - max_ref_len, ce + 1,
                                  max_ref_len, positions=region_positions)[0],
                        reference, cs + 1, ce + 1, params)
                    for cs, ce in bounds]
                _enter_contig(contig)
                regions = _build_regions(u, bounds, results)

                def fill_reads(region, _reads=region_reads, _mrl=max_ref_len,
                               _pos=region_positions):
                    region.reads, _ = aln_slice(_reads, region.padded_start(),
                                                region.padded_end(), _mrl,
                                                positions=_pos)

                _consume_unit(u, _iter_region_results_serial(
                    params, regions, deletions, use_device_pairhmm, fill_reads))

    # a traced job (the recorder on) records in the workers too
    traced = pool is not None and trace.enabled()
    if traced:
        pool.trace_workers(trace.current_job())
    try:
        _consume_all_units()
    except BaseException:
        # stop the pump thread before propagating: a daemon thread
        # blocked in q.get() would otherwise outlive this call, pinning
        # its buffered payloads (the pump's own sticky error, if any,
        # is subsumed by the in-flight exception)
        try:
            pump.close()
        except BaseException:
            pass
        if traced:
            pool.trace_workers(None)
        raise
    pump.close()  # joins the combiner thread; re-raises its failure
    if traced:
        pool.drain_traces()
    if gvcf and combiner is not None:
        out_variants = flush_runs(out_variants)
        final = combiner.finalize()
        if final is not None:
            out_variants.append(final)
    if variant_sink is not None:
        variant_sink.write_variants(out_variants)
        out_variants = []
    return vcf_header, out_variants

