"""Read clipping library (reference: filters/utils.go:81-627).

Faithful per-read transliterations of the clipping operations used by
BQSR and the HaplotypeCaller. These run on the host over a small mutable
``ClipRead`` view; the expensive per-base work stays on device. CIGARs
are lists of (length:int, op:str) pairs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

CigarOps = List[Tuple[int, str]]

_READ_CONS = frozenset("MIS=X")
_REF_CONS = frozenset("MDN=X")

MULTIPLE = 0x1
UNMAPPED = 0x4
NEXT_UNMAPPED = 0x8
REVERSED = 0x10
NEXT_REVERSED = 0x20


def read_length_from_cigar(cigar: CigarOps) -> int:
    return sum(l for l, o in cigar if o in _READ_CONS)


def reference_length_from_cigar(cigar: CigarOps) -> int:
    return sum(l for l, o in cigar if o in _REF_CONS)


@dataclass(slots=True)
class ClipRead:
    """Mutable per-read view for clipping (mirrors the Alignment fields
    the reference clipping code touches)."""

    flag: int
    pos: int
    pnext: int
    tlen: int
    mapq: int
    cigar: CigarOps
    seq: bytes
    qual: bytes
    rname: bytes = b""
    rnext: bytes = b""
    qname: bytes = b""
    # original batch row + current kept subrange of original read bases
    row: int = -1
    base_start: int = 0  # offset of seq[0] in the original read

    def is_reversed(self) -> bool:
        return (self.flag & REVERSED) != 0

    def end(self) -> int:
        return self.pos + reference_length_from_cigar(self.cigar) - 1

    # compact pickling: millions of ClipReads cross the HC worker-pool
    # pipes; a positional tuple beats the default per-object __dict__
    def __reduce__(self):
        return (_mk_clipread, (self.flag, self.pos, self.pnext, self.tlen,
                               self.mapq, self.cigar, self.seq, self.qual,
                               self.rname, self.rnext, self.qname, self.row,
                               self.base_start))


def _mk_clipread(*args) -> "ClipRead":
    return ClipRead(*args)


def is_strict_unmapped(r: ClipRead) -> bool:
    """(reference: filters/utils.go:140-142)"""
    return (r.flag & UNMAPPED) != 0 or r.rname in (b"", b"*") or r.pos == 0


def is_strict_next_unmapped(r: ClipRead) -> bool:
    """(reference: filters/utils.go:144-146)"""
    return (r.flag & NEXT_UNMAPPED) != 0 or r.rnext in (b"", b"*") or r.pnext == 0


def has_well_defined_fragment_size(r: ClipRead) -> Tuple[bool, int]:
    """(reference: filters/utils.go:148-157)"""
    if (
        r.tlen != 0
        and (r.flag & MULTIPLE)
        and not is_strict_unmapped(r)
        and not is_strict_next_unmapped(r)
        and ((r.flag & REVERSED) != 0) != ((r.flag & NEXT_REVERSED) != 0)
    ):
        if r.is_reversed():
            aln_end = r.end()
            return aln_end > r.pnext, aln_end
        return r.pos <= r.pnext + r.tlen, -1
    return False, -1


def compute_adaptor_boundary(r: ClipRead) -> Tuple[int, int, bool]:
    """(reference: filters/utils.go:159-170)"""
    well_defined, aln_end = has_well_defined_fragment_size(r)
    if well_defined:
        if r.is_reversed():
            boundary = r.pnext - 1
        else:
            boundary = r.pos + abs(r.tlen)
        return boundary, aln_end, True
    return -1, -1, False


def is_inside_read(r: ClipRead, aln_end: int, ref_coord: int) -> bool:
    """(reference: filters/utils.go:172-180)"""
    if ref_coord >= r.pos:
        if aln_end < 0:
            aln_end = r.end()
        return ref_coord <= aln_end
    return False


def read_starts_with_insertion(cigar: CigarOps) -> Tuple[int, bool]:
    """(reference: filters/bqsr.go:287-299)"""
    for length, op in cigar:
        if op == "I":
            return length, True
        if op in ("H", "S"):
            continue
        return -1, False
    return -1, False


def soft_start(r: ClipRead) -> int:
    """(reference: filters/utils.go:224-234)"""
    start = r.pos
    for length, op in r.cigar:
        if op == "S":
            start -= length
        elif op != "H":
            break
    return start


def soft_end(r: ClipRead) -> int:
    """(reference: filters/utils.go:236-248)"""
    end = r.end()
    se = end
    for length, op in reversed(r.cigar):
        if op == "S":
            se += length
        elif op != "H":
            return se
    return end


def compute_read_coordinate_for_reference_coordinate(
    cigar: CigarOps, soft_start_: int, ref_index: int
) -> Tuple[int, bool]:
    """(reference: filters/utils.go:278-327)"""
    goal = ref_index - soft_start_
    if goal < 0:
        return -1, False
    read_bases = 0
    ref_bases = 0
    falls_inside = False
    ends_just_before = False
    falls_inside_or_just_before = False
    index = 0
    n = len(cigar)
    while ref_bases != goal and index < n:
        length, op = cigar[index]
        index += 1
        shift = 0
        if op in _REF_CONS or op == "S":
            if ref_bases + length < goal:
                shift = length
            else:
                shift = goal - ref_bases
            ref_bases += shift
        if ref_bases != goal:
            read_bases += (length if op in _READ_CONS else 0)
        else:
            if shift >= length and index == n:
                return -1, False
            next_op = None
            if shift < length:
                falls_inside = op in ("D", "N")
            else:
                next_len, next_op = cigar[index]
                index += 1
                if next_op == "I":
                    read_bases += next_len
                    if index == n:
                        return -1, False
                    next_len, next_op = cigar[index]
                    index += 1
                ends_just_before = next_op in ("D", "N")
            falls_inside_or_just_before = ends_just_before or falls_inside
            if not falls_inside_or_just_before:
                read_bases += (shift if op in _READ_CONS else 0)
            elif ends_just_before:
                read_bases += ((shift - 1) if op in _READ_CONS else 0)
            elif falls_inside or (ends_just_before and next_op in ("D", "N")):
                read_bases -= 1
    if ref_bases != goal:
        return -1, False
    return read_bases, falls_inside_or_just_before


LEFT = 0
RIGHT = 1


def get_read_coordinate_for_reference_coordinate(
    cigar: CigarOps, soft_start_: int, ref_index: int, tail: int
) -> Tuple[int, bool]:
    """(reference: filters/utils.go:335-350)"""
    read_bases, falls = compute_read_coordinate_for_reference_coordinate(
        cigar, soft_start_, ref_index
    )
    if read_bases == -1:
        return -1, False
    if tail == RIGHT and falls:
        read_bases += 1
    if tail == LEFT and read_bases == 0:
        first_len, starts_with_ins = read_starts_with_insertion(cigar)
        if starts_with_ins:
            read_bases = min(first_len, read_length_from_cigar(cigar) - 1)
    return read_bases, True


def _calculate_hard_soft_offset(cigar: CigarOps) -> int:
    """(reference: filters/utils.go:352-371)"""
    size = 0
    i = 0
    while i < len(cigar) and cigar[i][1] == "H":
        size += cigar[i][0]
        i += 1
    while i < len(cigar) and cigar[i][1] == "S":
        size += cigar[i][0]
        i += 1
    return size


def _calculate_aln_start_shift(cigar: CigarOps, clipped: CigarOps) -> int:
    return _calculate_hard_soft_offset(clipped) - _calculate_hard_soft_offset(cigar)


def _hard_clipping_shift(op: str, op_ref_len: int, cigar_length: int) -> int:
    """calculateHardClippingAlignmentShift (reference: filters/utils.go:377-386).
    NB: for D/N it returns the *operation's* length, for I minus the
    passed-in length."""
    if op == "I":
        return -cigar_length
    if op in ("D", "N"):
        return op_ref_len
    return 0


def _clean_hard_clipped_cigar(cigar: CigarOps) -> CigarOps:
    """(reference: filters/utils.go:474-504)"""
    total = 0
    index = 0
    while index < len(cigar) and cigar[index][1] in ("H", "D", "N"):
        total += cigar[index][0]
        index += 1
    if index > 0:
        cigar = [(total, "H")] + cigar[index:]
    total = 0
    index = len(cigar) - 1
    while index >= 0 and cigar[index][1] in ("H", "D", "N"):
        total += cigar[index][0]
        index -= 1
    if index < len(cigar) - 1:
        cigar = cigar[: index + 1] + [(total, "H")]
    return cigar


def _hard_clip_cigar(r: ClipRead, start: int, stop: int) -> CigarOps:
    """(reference: filters/utils.go:407-472)"""
    cigar = r.cigar
    index = 0
    total_hard_clip = stop - start + 1
    shift = 0
    new_cigar: CigarOps = []
    if start == 0:
        k = 0
        while k < len(cigar) and cigar[k][1] == "H":
            total_hard_clip += cigar[k][0]
            k += 1
        while index <= stop and k < len(cigar):
            length, op = cigar[k]
            k += 1
            consumed = length if op in _READ_CONS else 0
            if index + consumed == stop + 1:
                shift += _hard_clipping_shift(op, length, length)
                new_cigar.append((total_hard_clip + shift, "H"))
            elif index + consumed > stop + 1:
                length_after = length - (stop - index + 1)
                shift += _hard_clipping_shift(op, length, stop - index + 1)
                new_cigar.append((total_hard_clip + shift, "H"))
                new_cigar.append((length_after, op))
            index += consumed
            shift += _hard_clipping_shift(op, length, consumed)
        new_cigar.extend(cigar[k:])
    else:
        k = 0
        while index < start and k < len(cigar):
            length, op = cigar[k]
            k += 1
            consumed = length if op in _READ_CONS else 0
            if index + consumed < start:
                new_cigar.append((length, op))
            else:
                length_after = start - index
                shift += _hard_clipping_shift(op, length, length - (start - index))
                if op == "H":
                    total_hard_clip += length_after
                else:
                    new_cigar.append((length_after, op))
            index += consumed
        while k < len(cigar):
            length, op = cigar[k]
            k += 1
            shift += _hard_clipping_shift(op, length, length)
            if op == "H":
                total_hard_clip += length
        new_cigar.append((total_hard_clip + shift, "H"))
    return _clean_hard_clipped_cigar(new_cigar)


def hard_clip(r: ClipRead, start: int, stop: int) -> None:
    """(reference: filters/utils.go:388-405)"""
    clipped_cigar = _hard_clip_cigar(r, start, stop)
    read_length = len(r.seq)
    new_length = read_length - (stop - start + 1)
    copy_start = 0
    if start == 0:
        copy_start = stop + 1
    old_cigar = r.cigar
    r.seq = r.seq[copy_start : copy_start + new_length]
    r.qual = r.qual[copy_start : copy_start + new_length]
    r.base_start += copy_start
    r.cigar = clipped_cigar
    if start == 0 and not is_strict_unmapped(r):
        r.pos += _calculate_aln_start_shift(old_cigar, clipped_cigar)


def hard_clip_by_reference_coordinates_left_tail(r: ClipRead, ref_stop: int) -> None:
    """(reference: filters/utils.go:250-256)"""
    stop, ok = get_read_coordinate_for_reference_coordinate(
        r.cigar, soft_start(r), ref_stop, LEFT
    )
    if not ok:
        raise ValueError("reference coordinate matches a non-existing base in read")
    hard_clip(r, 0, stop)


def hard_clip_by_reference_coordinates_right_tail(r: ClipRead, ref_start: int) -> None:
    """(reference: filters/utils.go:258-265)"""
    start, ok = get_read_coordinate_for_reference_coordinate(
        r.cigar, soft_start(r), ref_start, RIGHT
    )
    stop = len(r.seq) - 1
    if not ok:
        raise ValueError("reference coordinate matches a non-existing base in read")
    hard_clip(r, start, stop)


def hard_clip_adaptor_sequence(r: ClipRead) -> None:
    """(reference: filters/utils.go:214-222)"""
    boundary, aln_end, ok = compute_adaptor_boundary(r)
    if ok and is_inside_read(r, aln_end, boundary):
        if r.is_reversed():
            hard_clip_by_reference_coordinates_left_tail(r, boundary)
        else:
            hard_clip_by_reference_coordinates_right_tail(r, boundary)


def hard_clip_soft_clipped_bases(r: ClipRead) -> None:
    """(reference: filters/utils.go:506-534)"""
    read_index = 0
    cut_left = -1
    cut_right = -1
    right_tail = False
    for length, op in r.cigar:
        if op == "S":
            if right_tail:
                cut_right = read_index
            else:
                cut_left = read_index + length - 1
        elif op == "H":
            pass
        else:
            right_tail = True
        read_index += length if op in _READ_CONS else 0
    if cut_right >= 0:
        hard_clip(r, cut_right, len(r.seq) - 1)
    if cut_left >= 0:
        hard_clip(r, 0, cut_left)


def empty_read(r: ClipRead) -> None:
    """(reference: filters/utils.go:536-547) — tag handling is done by
    callers on the batch columns."""
    r.flag |= UNMAPPED
    r.mapq = 0
    r.cigar = []
    r.seq = b""
    r.qual = b""


def hard_clip_low_qual_ends(r: ClipRead, low_qual: int) -> None:
    """(reference: filters/utils.go:549-568)"""
    length = len(r.seq)
    left, right = 0, length - 1
    while right >= 0 and r.qual[right] <= low_qual:
        right -= 1
    while left < length and r.qual[left] <= low_qual:
        left += 1
    if left > right:
        empty_read(r)
        return
    if right < length - 1:
        hard_clip(r, right + 1, length - 1)
    if left > 0:
        hard_clip(r, 0, left - 1)


def revert_soft_clipped_bases(r: ClipRead) -> None:
    """(reference: filters/utils.go:570-602)"""
    unclipped: CigarOps = []
    matches = 0
    for length, op in r.cigar:
        if op in ("S", "M"):
            matches += length
        else:
            if matches > 0:
                unclipped.append((matches, "M"))
                matches = 0
            unclipped.append((length, op))
    if matches > 0:
        unclipped.append((matches, "M"))
    new_start = r.pos + _calculate_aln_start_shift(r.cigar, unclipped)
    r.cigar = unclipped
    if new_start <= 0:
        r.pos = 1
        hard_clip(r, 0, -new_start)
        if not is_strict_unmapped(r):
            r.pos = 1
    else:
        r.pos = new_start


def hard_clip_to_region(r: ClipRead, start: int, stop: int) -> None:
    """(reference: filters/utils.go:604-627)"""
    if len(r.seq) == 0 or start - 1 == stop + 1:
        empty_read(r)
        return
    aln_start, aln_stop = r.pos, r.end()
    if aln_start <= stop and aln_stop >= start:
        if aln_stop > stop:
            hard_clip_by_reference_coordinates_right_tail(r, stop + 1)
            if aln_start < start and start - 1 > r.end():
                empty_read(r)
                return
        if aln_start < start:
            hard_clip_by_reference_coordinates_left_tail(r, start - 1)
    else:
        empty_read(r)


def is_inside_deletion(cigar: CigarOps, offset: int) -> bool:
    """(reference: filters/utils.go:182-203)"""
    if offset < 0:
        return False
    pos = 0
    prev_pos = 0
    for length, op in cigar:
        if op in "ISDM=X":
            prev_pos = pos
            pos += length
        if prev_pos < offset <= pos and op == "D":
            return True
    return False
