"""Simple filters (reference: filters/simple-filters.go, 355 LoC).

Each function mirrors one reference filter closure; they operate on
columnar batches with vectorized numpy, mutating columns in place and/or
returning keep masks.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from ..core.batch import (
    DUPLICATE,
    UNMAPPED,
    ReadBatch,
)
from ..core.header import Header, SortingOrder
from ..core.pipeline import BatchFilter, Filter


def _name_mask(batch: ReadBatch, predicate) -> np.ndarray:
    """Boolean per-name-pool mask -> per-read mask via rname ids."""
    pool_mask = np.array([predicate(nm) for nm in batch.names], dtype=bool)
    return pool_mask[batch.rname_id]


def replace_reference_sequence_dictionary(dict_records: List[Dict[str, str]]) -> Filter:
    """(reference: filters/simple-filters.go:34-60)"""

    def filter_(header: Header) -> BatchFilter:
        if header.hd is not None and header.hd.get("SO") == "coordinate":
            previous_pos = -1
            old_sns = [e.get("SN") for e in header.sq]
            for entry in dict_records:
                sn = entry.get("SN")
                try:
                    pos = old_sns.index(sn)
                except ValueError:
                    pos = -1
                if pos >= 0:
                    if pos > previous_pos:
                        previous_pos = pos
                    else:
                        header.set_hd_so(SortingOrder.UNKNOWN)
                        break
        dict_table = {b"*"}
        for entry in dict_records:
            dict_table.add(entry["SN"].encode())
        header.sq = dict_records

        def bf(batch: ReadBatch) -> np.ndarray:
            return _name_mask(batch, lambda nm: nm in dict_table)

        return bf

    return filter_


def replace_reference_sequence_dictionary_from_sam_file(sam_file: str) -> Filter:
    """(reference: filters/simple-filters.go:65-69)"""
    from ..io.sam import read_sam_file

    hdr, _ = read_sam_file(sam_file)
    return replace_reference_sequence_dictionary(hdr.sq)


def remove_unmapped_reads(_: Header) -> BatchFilter:
    """(reference: filters/simple-filters.go:73-75)"""

    def bf(batch: ReadBatch) -> np.ndarray:
        return (batch.flag & UNMAPPED) == 0

    return bf


def remove_unmapped_reads_strict(_: Header) -> BatchFilter:
    """(reference: filters/simple-filters.go:79-83)"""

    def bf(batch: ReadBatch) -> np.ndarray:
        star = _name_mask(batch, lambda nm: nm == b"*")
        return ((batch.flag & UNMAPPED) == 0) & (batch.pos != 0) & ~star

    return bf


_NON_EXACT_OPS = frozenset(b"IDNHPX=")


def remove_non_exact_mapping_reads(_: Header) -> BatchFilter:
    """Only M and S CIGAR ops allowed (reference: simple-filters.go:90-99)."""

    def bf(batch: ReadBatch) -> np.ndarray:
        ops = batch.cigar_op
        bad_flat = np.isin(ops.data, np.frombuffer(b"IDNHPX=", np.uint8))
        # reduce per read: any bad op
        keep = np.ones(len(batch), bool)
        if bad_flat.any():
            read_idx = np.repeat(np.arange(len(batch)), ops.lengths)
            bad_reads = np.unique(read_idx[bad_flat])
            keep[bad_reads] = False
        return keep

    return bf


def remove_non_exact_mapping_reads_strict(_: Header) -> BatchFilter:
    """X0=1, X1=0, XM=0, XO=0, XG=0 (reference: simple-filters.go:115-134)."""

    def bf(batch: ReadBatch) -> np.ndarray:
        keep = np.ones(len(batch), bool)
        for tag, want in ((b"X0", 1), (b"X1", 0), (b"XM", 0), (b"XO", 0), (b"XG", 0)):
            vals, present = batch.tags.extract_i(tag)
            keep &= present & (vals == want)
        return keep

    return bf


def remove_duplicate_reads(_: Header) -> BatchFilter:
    """(reference: simple-filters.go:138-140)"""

    def bf(batch: ReadBatch) -> np.ndarray:
        return (batch.flag & DUPLICATE) == 0

    return bf


def remove_optional_reads(header: Header) -> Optional[BatchFilter]:
    """Drop split-file duplicated reads tagged sr (reference: simple-filters.go:146-152)."""
    if "@sr" in header.user_records:
        del header.user_records["@sr"]

        def bf(batch: ReadBatch) -> np.ndarray:
            return ~batch.tags.has_tag(b"sr")

        return bf
    return None


def add_or_replace_read_group(read_group: Dict[str, str]) -> Filter:
    """(reference: simple-filters.go:156-162)"""

    def filter_(header: Header) -> BatchFilter:
        header.rg = [read_group]
        rg_id = read_group["ID"].encode()

        def bf(batch: ReadBatch) -> None:
            batch.tags = batch.tags.set_z(b"RG", rg_id)
            return None

        return bf

    return filter_


def add_pg_line(new_pg: Dict[str, str]) -> Filter:
    """Add @PG as head of the chain (reference: simple-filters.go:166-184)."""

    def filter_(header: Header) -> None:
        pg_id = new_pg["ID"]
        while any(entry.get("ID") == pg_id for entry in header.pg):
            pg_id += " " + format(random.getrandbits(16), "x")
        new_pg["ID"] = pg_id
        for pg in header.pg:
            next_id = pg.get("ID")
            if not any(entry.get("PP") == next_id for entry in header.pg):
                new_pg["PP"] = next_id
                break
        header.pg.append(new_pg)
        return None

    return filter_


def rename_chromosomes(header: Header) -> BatchFilter:
    """Prepend "chr" to SQ SN and read RNAME/RNEXT (reference: simple-filters.go:189-204)."""
    for entry in header.sq:
        if "SN" in entry:
            entry["SN"] = "chr" + entry["SN"]

    def bf(batch: ReadBatch) -> None:
        batch.names = [
            nm if nm in (b"=", b"*") else b"chr" + nm for nm in batch.names
        ]
        return None

    return bf


def add_refid(header: Header) -> BatchFilter:
    """Write REFID/NextREFID temp columns from the @SQ index
    (reference: simple-filters.go:208-231)."""
    dict_table = {b"*": -1}
    for index, entry in enumerate(header.sq):
        dict_table[entry["SN"].encode()] = index

    def bf(batch: ReadBatch) -> None:
        pool_ref = np.array(
            [dict_table.get(nm, -1) for nm in batch.names], dtype=np.int32
        ) if batch.names else np.zeros(0, np.int32)
        refid = pool_ref[batch.rname_id] if len(batch.names) else np.zeros(len(batch), np.int32)
        # RNEXT '=' resolves to the read's own REFID
        # (simple-filters.go:220-222)
        pool_eq = np.array([nm == b"=" for nm in batch.names], dtype=bool) \
            if batch.names else np.zeros(0, bool)
        is_eq = pool_eq[batch.rnext_id] if len(batch.names) else np.zeros(len(batch), bool)
        next_refid = np.where(
            is_eq, refid, pool_ref[batch.rnext_id] if len(batch.names) else 0
        ).astype(np.int32)
        batch.temps["REFID"] = refid
        batch.temps["NextREFID"] = next_refid
        return None

    return bf


def remove_optional_fields(tags: List[str]) -> Optional[Filter]:
    """(reference: simple-filters.go:235-257)"""
    if not tags:
        return None
    tag_bytes = [t.encode() for t in tags]

    def filter_(header: Header) -> BatchFilter:
        def bf(batch: ReadBatch) -> None:
            batch.tags = batch.tags.remove_tags(tag_bytes)
            return None

        return bf

    return filter_


def keep_optional_fields(tags: List[str]) -> Filter:
    """(reference: simple-filters.go:261-288)"""
    tag_bytes = [t.encode() for t in tags]

    def filter_(header: Header) -> BatchFilter:
        def bf(batch: ReadBatch) -> None:
            if not tag_bytes:
                from ..core.batch import TagsColumn

                batch.tags = TagsColumn.empty(len(batch))
            else:
                batch.tags = batch.tags.keep_tags(tag_bytes)
            return None

        return bf

    return filter_


def _soft_clip_end_of_read(clip_from: int, lens: np.ndarray, ops: np.ndarray):
    """Transliteration of softClipEndOfRead + elementStradlessClippedRead
    (reference: filters/utils.go:81-119), bug-for-bug (including the
    ``pos += endPos`` accumulation)."""
    read_cons = frozenset(b"MIS=X")
    ref_cons = frozenset(b"MDN=X")
    read_len = sum(int(l) for l, o in zip(lens, ops) if o in read_cons)
    pos = 0
    clip_from -= 1
    new_lens: List[int] = []
    new_ops: List[int] = []
    for l, o in zip(lens, ops):
        end_pos = pos + (int(l) if o in read_cons else 0)
        if end_pos < clip_from:
            new_lens.append(int(l))
            new_ops.append(int(o))
        else:
            clipped_bases = read_len + clip_from
            rel = clip_from - pos
            if o in read_cons:
                if o in ref_cons:
                    if rel > 0:
                        new_lens.append(rel)
                        new_ops.append(int(o))
                else:
                    clipped_bases += rel
            elif rel != 0:
                raise ValueError("Unexpected non-0 relative clipping position in CleanSam.")
            new_lens.append(int(clipped_bases))
            new_ops.append(ord("S"))
            break
        pos += end_pos
    return new_lens, new_ops


def clean_sam(header: Header) -> BatchFilter:
    """Soft-clip past contig end; MAPQ=0 if unmapped
    (reference: simple-filters.go:292-306)."""
    ref_len_table = {}
    for sn in header.sq:
        ref_len_table[sn["SN"].encode()] = int(sn["LN"])

    def bf(batch: ReadBatch) -> None:
        from ..core.batch import Ragged
        from ..ops.readstats import pad_cigars, reference_length_from_cigar

        unmapped = (batch.flag & UNMAPPED) != 0
        batch.mapq = np.where(unmapped, 0, batch.mapq).astype(np.int32)
        if len(batch) == 0:
            return None
        op_class, op_len, n_ops = pad_cigars(batch.cigar_len, batch.cigar_op)
        ref_len = reference_length_from_cigar(op_class, op_len).cpu().numpy()
        end = batch.pos + ref_len - 1
        pool_len = np.array(
            [ref_len_table.get(nm, 0) for nm in batch.names], dtype=np.int64
        ) if batch.names else np.zeros(0, np.int64)
        contig_len = pool_len[batch.rname_id] if len(batch.names) else np.zeros(len(batch), np.int64)
        needs_clip = (~unmapped) & (end > contig_len)
        if needs_clip.any():
            new_rows_len = []
            new_rows_op = []
            for i in range(len(batch)):
                if needs_clip[i]:
                    clip_from = int(contig_len[i] - batch.pos[i] + 1)
                    nl, no = _soft_clip_end_of_read(
                        clip_from, batch.cigar_len.row(i), batch.cigar_op.row(i)
                    )
                    new_rows_len.append(np.array(nl, np.int32))
                    new_rows_op.append(np.array(no, np.uint8))
                else:
                    new_rows_len.append(batch.cigar_len.row(i))
                    new_rows_op.append(batch.cigar_op.row(i))
            batch.cigar_len = Ragged.from_rows(new_rows_len, np.int32)
            batch.cigar_op = Ragged.from_rows(new_rows_op, np.uint8)
        return None

    return bf


def remove_mapping_quality_less_than(mq: int) -> Optional[Filter]:
    """(reference: simple-filters.go:332-347)"""
    if mq == 0:
        return None

    def filter_(header: Header) -> BatchFilter:
        def bf(batch: ReadBatch) -> np.ndarray:
            if mq > 255:
                return np.zeros(len(batch), bool)
            return batch.mapq >= mq

        return bf

    return filter_


def clear_duplicate_flag(_: Header) -> BatchFilter:
    """(reference: simple-filters.go:350-355)"""

    def bf(batch: ReadBatch) -> None:
        batch.flag = (batch.flag & ~DUPLICATE).astype(np.int32)
        return None

    return bf


def remove_non_overlapping_reads(bed) -> Filter:
    """Keep reads overlapping BED regions (reference: simple-filters.go:310-328)."""
    from ..io import intervals as iv

    ivals = iv.from_bed(bed)
    for chrom in list(ivals):
        ivals[chrom] = iv.flatten(iv.sort_by_start(ivals[chrom]))

    def filter_(header: Header) -> BatchFilter:
        def bf(batch: ReadBatch) -> np.ndarray:
            from ..ops.readstats import pad_cigars, read_length_from_cigar, reference_length_from_cigar

            n = len(batch)
            if n == 0:
                return np.ones(0, bool)
            op_class, op_len, n_ops = pad_cigars(batch.cigar_len, batch.cigar_op)
            rd_len = read_length_from_cigar(op_class, op_len).cpu().numpy()
            rf_len = reference_length_from_cigar(op_class, op_len).cpu().numpy()
            aln_start = batch.pos
            aln_end = np.where(
                ((batch.flag & UNMAPPED) == 0) & (rd_len > 0),
                batch.pos + rf_len - 1,
                batch.pos,
            )
            keep = np.zeros(n, bool)
            rnames = batch.rname_bytes()
            for i in range(n):
                chrom_ivals = ivals.get(rnames[i].decode(), None)
                keep[i] = iv.overlap(chrom_ivals, int(aln_start[i]), int(aln_end[i]))
            return keep

        return bf

    return filter_
