"""Multi-file input: header merging with RG/PG collision renaming
(reference: sam/merge-inputs.go:16-219).

``merge_inputs(paths)`` parses every header, merges them (SQ
order-preserving union, RG/PG ID-collision renaming, HD/CO/user-record
union) and returns (header, per-batch tag-rewrite filters). Unlike the
reference's time-based rename suffix, collisions rename with a
deterministic per-file ordinal so reruns are reproducible."""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.batch import ReadBatch
from ..core.header import Header, SortingOrder


def _member_of_dict(dict_: List[Dict[str, str]], seq: str) -> Tuple[int, bool]:
    for i, sq in enumerate(dict_):
        if sq.get("SN") == seq:
            return i, True
    return -1, False


def merge_sequence_dictionaries(to_dict: List[Dict[str, str]],
                                from_dict: List[Dict[str, str]]) -> List[Dict[str, str]]:
    """(reference: mergeSequenceDictionaries, merge-inputs.go:74-110)"""
    new_dict: List[Dict[str, str]] = []
    j = 0
    for i_to, sq in enumerate(to_dict):
        sn = sq["SN"]
        i_from, ok = _member_of_dict(from_dict, sn)
        if ok:
            i_new, ok2 = _member_of_dict(new_dict, sn)
            if ok2:
                if i_new != i_to:
                    raise ValueError("Cannot merge sequence dictionaries.")
                j = i_new + 1
            else:
                new_dict = merge_sequence_dictionaries(new_dict, from_dict[j:i_from])
                new_dict.append(sq)
                j = i_from + 1
        else:
            new_dict.append(sq)
    new_dict.extend(from_dict[j:])
    return new_dict


TagRewrite = Callable[[ReadBatch], None]


def _replace_z_tag_filter(tag: bytes, old: str, new: str) -> TagRewrite:
    old_b, new_b = old.encode(), new.encode()

    def rewrite(batch: ReadBatch) -> None:
        vals = batch.tags.extract_z(tag)
        hits = np.flatnonzero(vals == old_b)
        if len(hits):
            from ..core.batch import TagsColumn

            rows = []
            hitset = set(hits.tolist())
            needle = tag + b":Z:" + old_b
            repl = tag + b":Z:" + new_b
            for i in range(len(batch)):
                row = batch.tags.row(i)
                if i in hitset:
                    row = b"\t".join(
                        repl if f == needle else f for f in row.split(b"\t"))
                rows.append(row)
            batch.tags = TagsColumn.from_rows(rows)

    return rewrite


def merge_headers(to_header: Header, from_header: Header,
                  rename_ordinal: int) -> List[TagRewrite]:
    """(reference: mergeHeaders, merge-inputs.go:29-46)"""
    rewrites: List[TagRewrite] = []
    # HD metadata union
    if from_header.hd:
        to_header.ensure_hd().update(from_header.hd)
    # SQ
    to_header.sq = merge_sequence_dictionaries(to_header.sq, from_header.sq)
    # RG with collision renaming
    to_ids = {r.get("ID") for r in to_header.rg}
    for record in from_header.rg:
        rid = record.get("ID")
        if rid in to_ids:
            new_id = f"{rid}-{rename_ordinal}"
            record = dict(record)
            record["ID"] = new_id
            rewrites.append(_replace_z_tag_filter(b"RG", rid, new_id))
        to_header.rg.append(record)
    # PG with collision renaming + PP chain repair
    to_pg_ids = {r.get("ID") for r in to_header.pg}
    replaced: Dict[str, str] = {}
    for record in from_header.pg:
        pid = record.get("ID")
        if pid in to_pg_ids:
            new_id = f"{pid}-{rename_ordinal}"
            record = dict(record)
            record["ID"] = new_id
            replaced[pid] = new_id
            rewrites.append(_replace_z_tag_filter(b"PG", pid, new_id))
        to_header.pg.append(record)
    for record in to_header.pg:
        pp = record.get("PP")
        if pp in replaced:
            record["PP"] = replaced[pp]
    # comments + user records
    to_header.co.extend(from_header.co)
    to_header.user_records.update(from_header.user_records)
    to_header.set_hd_so(SortingOrder.UNKNOWN)
    return rewrites


def merge_inputs(paths: List[str]) -> Tuple[Header, List[TagRewrite]]:
    """(reference: MergeInputs, merge-inputs.go:16-28)"""
    from . import sam as samio

    new_header: Optional[Header] = None
    rewrites: List[TagRewrite] = []
    for ordinal, path in enumerate(paths):
        hdr, _ = samio.read_sam_file(path)  # header + body; header reused
        if new_header is None:
            new_header = hdr
            continue
        rewrites.extend(merge_headers(new_header, hdr, ordinal))
    return new_header, rewrites


def read_and_merge_files(paths: List[str]) -> Tuple[Header, ReadBatch]:
    """Read several SAM/BAM files into one batch under a merged header."""
    from . import sam as samio

    if not paths:
        raise ValueError("no input files to merge")
    new_header: Optional[Header] = None
    batches: List[ReadBatch] = []
    for ordinal, path in enumerate(paths):
        hdr, batch = samio.read_sam_file(path)
        if new_header is None:
            new_header = hdr
        else:
            for rewrite in merge_headers(new_header, hdr, ordinal):
                rewrite(batch)
        batches.append(batch)
    return new_header, ReadBatch.concat(batches)
