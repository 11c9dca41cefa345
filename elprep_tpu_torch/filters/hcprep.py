"""Read-eligibility filters for the HaplotypeCaller
(reference: filters/haploutils.go:36-145, 301-355)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.batch import ReadBatch
from ..core.header import Header
from ..core.pipeline import BatchFilter

SECONDARY = 0x100
QC_FAILED = 0x200
DUPLICATE = 0x400
UNMAPPED = 0x4


def _is_good_cigar(cigar: List) -> bool:
    """(reference: isGoodCigar, haploutils.go:36-113)"""
    if not cigar:
        return False
    for ln, _op in cigar:
        if ln == 0:
            return False
    index = 0
    op = cigar[index][1]
    if op == "H":
        index += 1
        if index == len(cigar):
            return False
        if cigar[index][1] == "S":
            index += 1
            if index == len(cigar):
                return False
    elif op in "SP":
        index += 1
        if index == len(cigar):
            return False
    op = cigar[index][1]
    if op in "M=XN":
        index += 1
    elif op == "I":
        index += 1
        if index < len(cigar) and cigar[index][1] in "IDSH":
            return False
    else:
        return False
    while index < len(cigar):
        op = cigar[index][1]
        if op in "M=XN":
            index += 1
        elif op in "ID":
            index += 1
            if index < len(cigar):
                if cigar[index][1] in "IDSH":
                    return False
            elif op == "D":
                return False
        elif op == "P":
            index += 1
            if index < len(cigar):
                if cigar[index][1] in "PSH":
                    return False
            else:
                return False
        elif op == "S":
            index += 1
            if index < len(cigar):
                if cigar[index][1] != "H":
                    return False
                index += 1
                if index != len(cigar):
                    return False
            # trailing S ok
        elif op == "H":
            return index + 1 == len(cigar)
        else:
            return False
    return True


def haplotype_call_aln(header: Header) -> BatchFilter:
    """(reference: HaplotypeCallAln, haploutils.go:116-145). Drops TAGS
    of passing reads to save RAM, exactly like the reference."""
    sq_len = {sq["SN"].encode(): header.sq_ln(sq) for sq in header.sq}

    def bf(batch: ReadBatch) -> Optional[np.ndarray]:
        import os

        from ..core.batch import TagsColumn
        from .. import native

        n = len(batch)
        if n == 0:
            return None
        keep = np.ones(n, bool)
        has_sr = batch.tags.has_tag(b"sr")
        keep &= ~has_sr
        keep &= (batch.flag & (SECONDARY | DUPLICATE | QC_FAILED)) == 0
        rg_vals = batch.tags.extract_z(b"RG")
        names_pool = np.array(batch.names, dtype=bytes) if batch.names else np.array([b""], dtype=bytes)
        rnames = names_pool[batch.rname_id]
        seq_lens = batch.seq.lengths
        qual_lens = batch.qual.lengths
        unmapped = ((batch.flag & UNMAPPED) != 0) | (rnames == b"*") | (rnames == b"") | (batch.pos == 0)

        good = (None if os.environ.get("ELPREP_TPU_NO_NATIVE_GOODCIG")
                else native.good_cigar_mask(batch.cigar_len, batch.cigar_op))
        if good is not None:
            # columnar fast path: per-row CIGAR sums via op-class LUTs,
            # grammar check in the native kernel (oracle: the loop below)
            off = batch.cigar_len.offsets
            lens64 = batch.cigar_len.data.astype(np.int64)
            ops = batch.cigar_op.data
            ref_lut = np.zeros(256, np.int64)
            for c in b"MDN=X":
                ref_lut[c] = 1
            read_lut = np.zeros(256, np.int64)
            for c in b"MIS=X":
                read_lut[c] = 1
            rc = np.concatenate([[0], np.cumsum(ref_lut[ops] * lens64)])
            ref_len = rc[off[1:]] - rc[off[:-1]]
            dc = np.concatenate([[0], np.cumsum(read_lut[ops] * lens64)])
            read_len = dc[off[1:]] - dc[off[:-1]]
            nn = np.concatenate([[0], np.cumsum((ops == ord("N")).astype(np.int64))])
            has_n = (nn[off[1:]] - nn[off[:-1]]) > 0
            limit_by_rid = np.array(
                [sq_len.get(nm, -1) if sq_len.get(nm) is not None else -1
                 for nm in names_pool], np.int64)
            limits = limit_by_rid[batch.rname_id]
            keep &= (
                (ref_len != 0)
                & ~unmapped
                & (batch.pos > 0)
                & (limits >= 0) & (batch.pos <= limits)
                & (seq_lens == read_len)
                & (batch.mapq >= 20)
                & (batch.mapq != 255)
                & (rg_vals != b"")
                & (seq_lens == qual_lens)
                & (seq_lens > 0)
                & good
                & ~has_n
            )
        else:
            for i in range(n):
                if not keep[i]:
                    continue
                cigar = list(zip(batch.cigar_len.row(i).tolist(),
                                 batch.cigar_op.row(i).tobytes().decode()))
                ref_len = sum(ln for ln, op in cigar if op in "MDN=X")
                read_len = sum(ln for ln, op in cigar if op in "MIS=X")
                ln_limit = sq_len.get(rnames[i])
                keep[i] = (
                    ref_len != 0
                    and not unmapped[i]
                    and batch.pos[i] > 0
                    and ln_limit is not None and batch.pos[i] <= ln_limit
                    and seq_lens[i] == read_len
                    and batch.mapq[i] >= 20
                    and batch.mapq[i] != 255
                    and rg_vals[i] != b""
                    and seq_lens[i] == qual_lens[i]
                    and seq_lens[i] > 0
                    and _is_good_cigar(cigar)
                    and not any(op == "N" for _, op in cigar)
                )
        # drop TAGS (keep RG for downstream sample logic? the reference
        # nils TAGS after checking RG; the HC driver no longer needs them)
        batch.tags = TagsColumn.empty(n)
        return keep

    return bf


def filter_reads_by_sample_name(sample_name_box: List[str]):
    """(reference: FilterReadsBySampleName, haploutils.go:301-355).
    ``sample_name_box`` is a single-element list used as an in/out cell."""

    def filter_(header: Header) -> Optional[BatchFilter]:
        sample_name = sample_name_box[0]
        if sample_name != "":
            valid_rgs = []
            for rg in header.rg:
                if rg.get("SM") == sample_name:
                    rg_id = rg.get("ID")
                    if rg_id is None:
                        raise ValueError(
                            f"Unexpected read group without an ID for sample name {sample_name}.")
                    valid_rgs.append(rg_id.encode())
            if not valid_rgs:
                raise ValueError(
                    f"No read group available with requested sample name {sample_name}.")
            valid = set(valid_rgs)

            def bf(batch: ReadBatch) -> Optional[np.ndarray]:
                rg_vals = batch.tags.extract_z(b"RG")
                return np.array([v in valid for v in rg_vals], bool)

            return bf
        if header.rg:
            sm = header.rg[0].get("SM")
            if sm is not None:
                sample_name_box[0] = sm
                for rg in header.rg[1:]:
                    sm2 = rg.get("SM")
                    if sm2 is None:
                        raise ValueError(
                            f"Unexpected read group {rg.get('ID')} without a sample name; "
                            f"first sample name is {sample_name_box[0]}.")
                    if sm2 != sample_name_box[0]:
                        raise ValueError(
                            "Multiple sample names present. Ensure to request a particular sample name.")
            else:
                for rg in header.rg[1:]:
                    sm2 = rg.get("SM")
                    if sm2 is not None:
                        raise ValueError(
                            f"Unexpected read group {header.rg[0].get('ID')} without a sample name; "
                            f"some sample name is {sm2}.")
        return None

    return filter_
