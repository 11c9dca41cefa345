"""Split/merge of SAM/BAM files per contig group
(reference: sam/split-merge.go:174-827).

Splitting groups contigs into ~equal-length "contig groups"
(computeContigGroups :178-213); each group file gets `@cs` user header
records naming its contigs and an `@sr` marker; read pairs that cross
groups are written untagged into the spread file and duplicated into
their group file with an `sr:i:1` tag (:286-294). Merging concatenates
the per-group files (each coordinate-sorted, and group order follows
the sequence dictionary) and interleaves spread reads by (refid, POS)
with group reads winning ties — the columnar equivalent of the
reference's k-way streaming merge (:410-577).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core.batch import ReadBatch
from .core.header import Header
from .io import sam as samio


def format_group(index: int) -> str:
    return "group%05d" % index


def compute_contig_groups(sq: List[Dict[str, str]], contig_group_size: int
                          ) -> Tuple[List[str], Dict[str, str], Dict[str, List[str]]]:
    """(reference: computeContigGroups, split-merge.go:178-213)"""
    if contig_group_size <= 0:
        for sn in sq:
            ln = int(sn.get("LN", "0"))
            if ln > contig_group_size:
                contig_group_size = ln
        if contig_group_size <= 0:
            raise ValueError("no valid contig group size")
    groups = ["unmapped"]
    contig_to_group = {"*": "unmapped"}
    group_to_contigs: Dict[str, List[str]] = {"unmapped": ["*"]}
    index = 1
    size = 0
    current = format_group(index)
    for sn in sq:
        ln = int(sn.get("LN", "0"))
        if size > 0 and size + ln > contig_group_size:
            index += 1
            size = 0
            current = format_group(index)
        contig = sn["SN"]
        contig_to_group[contig] = current
        group_to_contigs.setdefault(current, []).append(contig)
        if groups[-1] != current:
            groups.append(current)
        size += ln
    return groups, contig_to_group, group_to_contigs


def split_file_per_chromosome(input_path: str, output_path: str,
                              output_prefix: str, output_extension: str,
                              contig_group_size: int = 0,
                              single_end: bool = False) -> None:
    """(reference: SplitFilePerChromosome, split-merge.go:230-311;
    single-end variant :664-724)"""
    if os.path.isdir(input_path):
        from .io.merge_inputs import read_and_merge_files

        files = sorted(os.path.join(input_path, f) for f in os.listdir(input_path)
                       if not f.startswith("."))
        hdr, batch = read_and_merge_files(files)
    else:
        hdr, batch = samio.read_sam_file(input_path)
    groups, contig_to_group, group_to_contigs = compute_contig_groups(
        hdr.sq, contig_group_size)
    splits_path = os.path.join(output_path, "splits")
    os.makedirs(splits_path, exist_ok=True)
    hdr.add_user_record("@sr", {"co": "This file was created using elprep split."})

    names_pool = np.array(batch.names, dtype=bytes) if batch.names else np.array([b""], dtype=bytes)
    rnames = names_pool[batch.rname_id]
    rnexts = names_pool[batch.rnext_id]
    n = len(batch)
    group_of = np.array([contig_to_group.get(r.decode(), "") for r in rnames])
    if (group_of == "").any():
        bad = rnames[group_of == ""][0]
        raise ValueError(f"read mapped to a region not present in the header: {bad}")
    is_spread = np.zeros(n, bool)
    if not single_end:
        next_group = np.array([
            contig_to_group.get(r.decode(), "") if r not in (b"=", b"*") else ""
            for r in rnexts
        ])
        # deliberate deviation from the reference: a mapped read with
        # RNEXT "*" has NO mate, so it stays in its group. The reference
        # sends it to the spread file (split-merge.go:286-294 treats any
        # RNEXT outside the group as cross-group), which computes its
        # duplicate verdict in spread-only context and forks it from the
        # whole-file run whenever the read collides with a pair at its
        # position — caught by the cross-mode differential
        # (tests/test_crossmode.py). Keeping mate-less reads local
        # preserves sfm == whole-file; genuine cross-group pairs keep
        # the spread mechanism unchanged.
        is_spread = ((rnexts != b"=") & (rnexts != b"*") & (rnames != b"*")
                     & (next_group != group_of))

    spread_out = None
    if not single_end:
        spread_name = os.path.join(output_path,
                                   output_prefix + "-spread." + output_extension)
        spread_batch = batch.select(is_spread)
        samio.write_sam_file(spread_name, hdr, spread_batch, fmt=output_extension)

    for group in groups:
        sel = group_of == group
        gb = batch.select(sel)
        if not single_end:
            # duplicate spread reads into their group file with sr:i:1
            gspread = is_spread[sel]
            if gspread.any():
                gb.tags = _set_sr_tag(gb.tags, gspread)
        ghdr = hdr.clone()
        ghdr.user_records["@cs"] = [{"cs": c} for c in group_to_contigs.get(group, [])]
        name = os.path.join(splits_path,
                            output_prefix + "-" + group + "." + output_extension)
        samio.write_sam_file(name, ghdr, gb, fmt=output_extension)


def _set_sr_tag(tags, mask: np.ndarray):
    from .core.batch import TagsColumn

    rows = []
    for i in range(len(tags)):
        row = tags.row(i)
        if mask[i]:
            row = (row + b"\tsr:i:1") if row else b"sr:i:1"
        rows.append(row)
    return TagsColumn.from_rows(rows)


def _coordinate_keys(hdr: Header, batch: ReadBatch) -> Tuple[np.ndarray, np.ndarray]:
    dict_table = {"*": -1}
    for index, entry in enumerate(hdr.sq):
        dict_table[entry["SN"]] = index
    names_pool = np.array(batch.names, dtype=bytes) if batch.names else np.array([b""], dtype=bytes)
    rnames = names_pool[batch.rname_id]
    refid = np.array([dict_table.get(r.decode(), -1) for r in rnames], np.int64)
    # unmapped (-1) sorts AFTER all contigs (split-merge.go:418-432)
    order_key = np.where(refid < 0, 2 ** 31, refid)
    return order_key, batch.pos.astype(np.int64)


def merge_sorted_files_split_per_chromosome(
        input_path: str, output: str, input_prefix: str, input_extension: str,
        output_format: str, hdr: Header) -> None:
    """(reference: MergeSortedFilesSplitPerChromosome, split-merge.go:410-577)"""
    parts: List[ReadBatch] = []
    index = 1
    while True:
        path = os.path.join(input_path,
                            input_prefix + "-" + format_group(index) + "." + input_extension)
        if not os.path.exists(path):
            break
        _, gb = samio.read_sam_file(path)
        parts.append(gb)
        index += 1
    body = ReadBatch.concat(parts) if parts else ReadBatch.empty()

    spread_path = os.path.join(input_path,
                               input_prefix + "-spread." + input_extension)
    if os.path.exists(spread_path):
        _, spread = samio.read_sam_file(spread_path)
        if len(spread):
            body = _interleave_spread(hdr, body, spread)

    unmapped_path = os.path.join(input_path,
                                 input_prefix + "-unmapped." + input_extension)
    if os.path.exists(unmapped_path):
        _, unmapped = samio.read_sam_file(unmapped_path)
        if len(unmapped):
            body = ReadBatch.concat([body, unmapped])

    out_hdr = hdr.clone()
    out_hdr.user_records.pop("@cs", None)
    samio.write_sam_file(output, out_hdr, body, fmt=output_format)


def _interleave_spread(hdr: Header, body: ReadBatch, spread: ReadBatch) -> ReadBatch:
    """Insert each spread read before the first group read that is
    STRICTLY greater under the full CoordinateLess comparator, with
    full-key ties keeping group reads first: the order of the whole-file
    run and of the reference's spread merge in cmd/filter.go:63
    (split-merge.go:417-434's own merge compares only (refid, POS)).

    Sequential insertion of key-sorted spread reads into a key-sorted
    body with that rule is exactly a stable full-key sort of
    [body..., spread...], so this reuses the packed-key native sort the
    coordinate sort itself runs on. An earlier version keyed only
    (refid, POS) and placed spread reads one row late — both bugs were
    caught by the cross-mode differential (tests/test_crossmode.py)
    against serial whole-file output."""
    from .core.pipeline import SamData, SortingOrder, run_pipeline
    from .filters import simple as fsimple
    from .ops import sortkeys

    merged = ReadBatch.concat([body, spread])
    md = run_pipeline(SamData(hdr, merged), [fsimple.add_refid],
                      SortingOrder.KEEP)
    b = md.batch
    perm = sortkeys.coordinate_sort_perm_host(
        b.flag, np.asarray(b.temps["REFID"]), b.pos, b.mapq,
        np.asarray(b.temps["NextREFID"]), b.pnext, b.tlen,
        sortkeys.qname_ranks(b.qname))
    return b.select(np.asarray(perm))


def merge_files_split_per_chromosome_without_spread(
        input_path: str, output: str, input_prefix: str, input_extension: str,
        output_format: str, hdr: Header) -> None:
    """Concatenate unmapped + group files, ignoring the spread file —
    used when the group files already contain their (contig-filtered)
    spread reads (reference: MergeSortedFilesSplitPerChromosome-
    WithoutSpreadFile, split-merge.go:621-658; note the reference
    writes the unmapped file FIRST)."""
    parts: List[ReadBatch] = []
    unmapped_path = os.path.join(input_path,
                                 input_prefix + "-unmapped." + input_extension)
    if os.path.exists(unmapped_path):
        _, unmapped = samio.read_sam_file(unmapped_path)
        parts.append(unmapped)
    index = 1
    while True:
        path = os.path.join(input_path,
                            input_prefix + "-" + format_group(index) + "." + input_extension)
        if not os.path.exists(path):
            break
        _, gb = samio.read_sam_file(path)
        parts.append(gb)
        index += 1
    body = ReadBatch.concat(parts) if parts else ReadBatch.empty()
    out_hdr = hdr.clone()
    out_hdr.user_records.pop("@cs", None)
    samio.write_sam_file(output, out_hdr, body, fmt=output_format)


def merge_unsorted_files_split_per_chromosome(
        input_path: str, output: str, input_prefix: str, input_extension: str,
        output_format: str, hdr: Header, single_end: bool = False) -> None:
    """(reference: MergeUnsortedFilesSplitPerChromosome, split-merge.go:581-619)"""
    parts: List[ReadBatch] = []
    index = 1
    while True:
        path = os.path.join(input_path,
                            input_prefix + "-" + format_group(index) + "." + input_extension)
        if not os.path.exists(path):
            break
        _, gb = samio.read_sam_file(path)
        parts.append(gb)
        index += 1
    spread_path = os.path.join(input_path, input_prefix + "-spread." + input_extension)
    if not single_end and os.path.exists(spread_path):
        _, spread = samio.read_sam_file(spread_path)
        parts.append(spread)
    unmapped_path = os.path.join(input_path, input_prefix + "-unmapped." + input_extension)
    if os.path.exists(unmapped_path):
        _, unmapped = samio.read_sam_file(unmapped_path)
        parts.append(unmapped)
    body = ReadBatch.concat(parts) if parts else ReadBatch.empty()
    out_hdr = hdr.clone()
    out_hdr.user_records.pop("@cs", None)
    samio.write_sam_file(output, out_hdr, body, fmt=output_format)


def header_from_any_split_file(input_path: str, input_prefix: str,
                               input_extension: str) -> Header:
    index = 1
    candidates = [os.path.join(input_path, input_prefix + "-" + format_group(index)
                               + "." + input_extension),
                  os.path.join(input_path, input_prefix + "-unmapped." + input_extension)]
    for path in candidates:
        if os.path.exists(path):
            hdr, _ = samio.read_sam_file(path)
            return hdr
    raise FileNotFoundError("no split files found in " + input_path)
