"""Smith-Waterman affine-gap alignment (reference: filters/sw.go).

Exact reimplementation of the reference's int32 DP with gap-size
backtrack values and its 4 overhang strategies (softclip / indel /
leadingIndel / ignore), including:

- the exact-substring fast path for softclip/ignore (sw.go:96-107);
- strictly-greater gap updates (ties keep the longer gap, sw.go:175-196);
- winner priority diag >= down && diag >= right -> diag, else
  right >= down -> right, else down (sw.go:198-208);
- the matrixMinCutoff clamp at -100000000 (sw.go:131-134);
- backtrack start selection incl. the |refLength-j| tie rule
  (sw.go:212-238) and per-strategy cigar finalization (sw.go:240-303).

Vectorization: rows run as numpy vector ops. The horizontal-gap
recursion F[j] = max(row[j-1]+open, F[j-1]+ext) is decoupled because
ext > open makes max(F[j-1]+open, F[j-1]+ext) = F[j-1]+ext, so F is a
prefix-max over G[k]+open+(j-1-k)*ext — one cummax per row instead of
the reference's sequential inner loop. Gap sizes fall out of the
strict-new-max argmax, preserving the reference's tie semantics.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

CigOp = Tuple[int, str]  # (length, operation)

SOFTCLIP = 0
INDEL = 1
LEADING_INDEL = 2
IGNORE = 3

MATRIX_MIN_CUTOFF = -100000000
LOW_INIT = -(2 ** 30)  # MinInt32/2

SW_PAD = b"N" * 10

# haplotype-to-reference scoring (sw.go:401)
HAP_SW_PARAMS = (200, -150, -260, -11)
# dangling-end recovery in assembly (assemble-reads.go:1042,1152)
ASSEMBLY_SW_PARAMS = (25, -50, -110, -6)
# read realignment (realign.go:310)
REALIGN_SW_PARAMS = (10, -15, -30, -5)


def last_index(ref: bytes, seq: bytes) -> int:
    """Rightmost exact occurrence of seq in ref (sw.go:96-107)."""
    return ref.rfind(seq)


def run_smith_waterman(
    reference: bytes,
    alternate: bytes,
    match_value: int,
    mismatch_penalty: int,
    gap_open: int,
    gap_extend: int,
    strategy: int,
) -> Tuple[List[CigOp], int]:
    if strategy in (SOFTCLIP, IGNORE):
        off = last_index(reference, alternate)
        if off >= 0:
            return [(len(alternate), "M")], off

    ref = np.frombuffer(reference, np.uint8).astype(np.int16)
    alt = np.frombuffer(alternate, np.uint8).astype(np.int16)
    nrow = len(ref) + 1
    ncol = len(alt) + 1

    sw = np.zeros((nrow, ncol), np.int64)
    bt = np.zeros((nrow, ncol), np.int64)

    if strategy in (INDEL, LEADING_INDEL):
        sw[0, 1:] = gap_open + np.arange(ncol - 1, dtype=np.int64) * gap_extend
        sw[1:, 0] = gap_open + np.arange(nrow - 1, dtype=np.int64) * gap_extend

    best_gap_v = np.full(ncol, LOW_INIT, np.int64)
    gap_size_v = np.zeros(ncol, np.int64)
    jj = np.arange(1, ncol, dtype=np.int64)  # j = 1..ncol-1

    for i in range(1, nrow):
        a = ref[i - 1]
        prev = sw[i - 1]
        step_diag = prev[:-1] + np.where(alt == a, match_value, mismatch_penalty)

        # vertical gaps (elementwise per column, sw.go:175-185)
        prev_gap = prev[1:] + gap_open
        best_gap_v[1:] += gap_extend
        newv = prev_gap > best_gap_v[1:]
        best_gap_v[1:] = np.where(newv, prev_gap, best_gap_v[1:])
        gap_size_v[1:] = np.where(newv, 1, gap_size_v[1:] + 1)
        step_down = best_gap_v[1:]
        kd = gap_size_v[1:]

        # horizontal gaps as a prefix-max scan:
        # F[j] = j*ext + cummax(G[k] + open - (k+1)*ext) over k<=j-1,
        # where G[k] = max(curRow-candidate before F, cutoff-clamped).
        # curRow[k] = max(CUTOFF, max(step_diag, step_down, F[k]));
        # but F[k]+open never beats F[j-1]+ext path (ext>open), so only
        # the diag/down part of curRow matters for opening a new gap.
        g = np.maximum(np.maximum(step_diag, step_down), MATRIX_MIN_CUTOFF)
        # careful: a horizontal gap can also open from column 0
        g_full = np.empty(ncol, np.int64)
        g_full[0] = sw[i, 0]
        g_full[1:] = g
        A = g_full[:-1] + gap_open - jj * gap_extend  # A[k] for k=0..ncol-2
        am = np.maximum.accumulate(A)
        strict_new = np.empty(ncol - 1, bool)
        strict_new[0] = True
        strict_new[1:] = A[1:] > am[:-1]
        arg = np.maximum.accumulate(np.where(strict_new, np.arange(ncol - 1), -1))
        F = am + jj * gap_extend
        # initial bestGapH path (LOW_INIT + accumulated extends)
        F_init = LOW_INIT + jj * gap_extend
        use_init = F_init > F
        step_right = np.where(use_init, F_init, F)
        ki = np.where(use_init, jj, jj - arg)

        diag_wins = (step_diag >= step_down) & (step_diag >= step_right)
        right_wins = ~diag_wins & (step_right >= step_down)
        cur = np.where(
            diag_wins, step_diag, np.where(right_wins, step_right, step_down)
        )
        sw[i, 1:] = np.maximum(MATRIX_MIN_CUTOFF, cur)
        bt[i, 1:] = np.where(diag_wins, 0, np.where(right_wins, -ki, kd))

    ref_len, alt_len = len(ref), len(alt)
    max_score = -(2 ** 62)
    segment_length = 0
    p1, p2 = 0, alt_len
    if strategy == INDEL:
        p1 = ref_len
    else:
        col = sw[1:, alt_len]
        # >= : later i wins ties (sw.go:218-224)
        p1 = int(np.flatnonzero(col >= np.maximum.accumulate(col))[-1]) + 1
        max_score = int(sw[p1, alt_len])
        if strategy != LEADING_INDEL:
            bottom = sw[ref_len]
            for j in range(1, ncol):
                cur_score = int(bottom[j])
                if cur_score > max_score or (
                    cur_score == max_score and abs(ref_len - j) < abs(p1 - p2)
                ):
                    p1 = ref_len
                    p2 = j
                    max_score = cur_score
                    segment_length = alt_len - j

    # backtrack (sw.go:240-276)
    lce: List[CigOp] = []
    if segment_length > 0 and strategy == SOFTCLIP:
        lce.append((segment_length, "S"))
        segment_length = 0
    state = "M"
    while True:
        btr = int(bt[p1, p2])
        if btr > 0:
            new_state = "D"
            step_length = btr
            p1 -= btr
        elif btr < 0:
            new_state = "I"
            step_length = -btr
            p2 += btr
        else:
            new_state = "M"
            step_length = 1
            p1 -= 1
            p2 -= 1
        if new_state == state:
            segment_length += step_length
        else:
            lce.append((segment_length, state))
            segment_length = step_length
            state = new_state
        if p1 <= 0 or p2 <= 0:
            break

    if strategy == SOFTCLIP:
        lce.append((segment_length, state))
        if p2 > 0:
            lce.append((p2, "S"))
        alignment_offset = p1
    elif strategy == IGNORE:
        lce.append((segment_length + p2, state))
        alignment_offset = p1 - p2
    else:
        lce.append((segment_length, state))
        if p1 > 0:
            lce.append((p1, "D"))
        elif p2 > 0:
            lce.append((p2, "I"))
        alignment_offset = 0

    lce.reverse()
    # merge zero-length and adjacent-equal ops, replicating the
    # reference's exact loop (it does NOT re-merge across a removed
    # zero-length element, sw.go:289-302)
    i = 1
    while i < len(lce):
        if lce[i - 1][0] == 0:
            del lce[i - 1]
        elif lce[i - 1][1] == lce[i][1]:
            lce[i - 1] = (lce[i - 1][0] + lce[i][0], lce[i][1])
            del lce[i]
        else:
            i += 1
    if lce and lce[-1][0] == 0:
        lce.pop()
    return lce, alignment_offset


# ---------------------------------------------------------------------------
# CIGAR utilities (reference: sw.go:320-412, realign.go:119-209,
# call-region.go:174-181)
# ---------------------------------------------------------------------------


def reference_length(cigar: List[CigOp]) -> int:
    return sum(ln for ln, op in cigar if op in "MDN=X")


def read_length(cigar: List[CigOp]) -> int:
    return sum(ln for ln, op in cigar if op in "MIS=X")


def is_sw_failure(cigar: List[CigOp], alignment_offset: int) -> bool:
    if alignment_offset > 0:
        return True
    return any(op == "S" for _, op in cigar)


def _add_cigar_element(new_cigar: List[CigOp], pos: int, start: int, end: int,
                       ln: int, op: str) -> int:
    length = min(pos + ln - 1, end) - max(pos, start) + 1
    if length > 0:
        new_cigar.append((length, op))
    return pos + ln


def trim_cigar_by_bases(cigar: List[CigOp], start: int, end: int) -> List[CigOp]:
    """(reference: sw.go:330-352)"""
    new_cigar: List[CigOp] = []
    pos = 0
    for ln, op in cigar:
        if op == "D":
            if pos >= start:
                new_cigar.append((ln, op))
                continue
        elif pos > end:
            break
        pos = _add_cigar_element(new_cigar, pos, start, end, ln, op)
    # replicate the reference's merge loop exactly: its `for` header
    # increments i alongside the else-branch increment, so a non-equal
    # pair advances by two (sw.go:344-351)
    i = 1
    while i < len(new_cigar):
        if new_cigar[i - 1][1] == new_cigar[i][1]:
            new_cigar[i - 1] = (new_cigar[i - 1][0] + new_cigar[i][0], new_cigar[i][1])
            del new_cigar[i]
            i += 1
        else:
            i += 2
    return new_cigar


def create_indel_string(cigar: List[CigOp], indel_index: int, indel: CigOp,
                        ref_seq: bytes, read_seq: bytes,
                        ref_index: int, read_index: int) -> Optional[bytes]:
    """(reference: realign.go:119-177)"""
    total_ref_bases = 0
    for ln, op in cigar[:indel_index]:
        if op in "M=X":
            read_index += ln
            ref_index += ln
            total_ref_bases += ln
        elif op == "S":
            read_index += ln
        elif op == "N":
            ref_index += ln
            total_ref_bases += ln
    if ref_index > len(ref_seq):
        return None
    indel_len, indel_op = indel
    if total_ref_bases + indel_len > len(ref_seq):
        indel_length = len(ref_seq) - total_ref_bases
    else:
        indel_length = indel_len
    alt_length = len(ref_seq)
    if indel_op == "D":
        alt_length -= indel_length
    else:
        alt_length += indel_length
    if ref_index > alt_length:
        return None
    out = bytearray()
    out += ref_seq[:ref_index]
    current_pos = ref_index
    if indel_op == "D":
        ref_index += indel_length
    else:
        out += read_seq[read_index : read_index + indel_length]
        current_pos += indel_length
    if len(ref_seq) - ref_index > alt_length - current_pos:
        return None
    out += ref_seq[ref_index:]
    return bytes(out[:alt_length])


def move_cigar_left(cigar: List[CigOp], indel_index: int) -> List[CigOp]:
    """(reference: realign.go:179-196)"""
    elements = list(cigar[: indel_index - 1])
    ln, op = cigar[indel_index - 1]
    elements.append((max(ln - 1, 0), op))
    elements.append(cigar[indel_index])
    if indel_index + 1 < len(cigar):
        ln, op = cigar[indel_index + 1]
        elements.append((ln + 1, op))
        elements.extend(cigar[indel_index + 2 :])
    else:
        elements.append((1, "M"))
    return elements


def left_align_indel(cigar: List[CigOp], ref_seq: bytes, read_seq: bytes,
                     ref_index: int, read_index: int, cleanup_cigar: bool) -> List[CigOp]:
    """(reference: realign.go:210-268)"""
    indel_index = -1
    indel: Optional[CigOp] = None
    for idx, (ln, op) in enumerate(cigar):
        if op in "DI":
            if indel_index != -1:
                return cigar
            indel_index = idx
            indel = (ln, op)
    if indel_index <= 0:
        return cigar

    alt_string = create_indel_string(cigar, indel_index, indel, ref_seq, read_seq,
                                     ref_index, read_index)
    if not alt_string:
        return cigar

    new_cigar = cigar
    i = 0
    while i < indel[0]:
        new_cigar = move_cigar_left(new_cigar, indel_index)
        new_alt = create_indel_string(new_cigar, indel_index, indel, ref_seq,
                                      read_seq, ref_index, read_index)
        if new_alt is not None and alt_string == new_alt:
            cigar = new_cigar
            i = -1
            if any(ln == 0 for ln, _ in new_cigar):
                if cleanup_cigar:
                    for k, (ln, op) in enumerate(cigar):
                        if ln != 0 and op != "D":
                            cigar = cigar[k:]
                            break
                    cigar = [e for e in cigar if e[0] != 0] or cigar
                return cigar
        else:
            if any(ln == 0 for ln, _ in new_cigar):
                return cigar
        i += 1
    return cigar


def left_align_cigar_sequentially(cigar: List[CigOp], reference: bytes,
                                  alternate: bytes) -> List[CigOp]:
    """(reference: sw.go:354-386)"""
    new_cigar: List[CigOp] = []
    cigar_to_align: List[CigOp] = []
    ref_index = 0
    read_index = 0
    for ce in cigar:
        if ce[1] in "DI":
            cigar_to_align.append(ce)
            new_cigar.extend(
                left_align_indel(cigar_to_align, reference, alternate,
                                 ref_index, read_index, False)
            )
            ref_index += reference_length(cigar_to_align)
            read_index += read_length(cigar_to_align)
            cigar_to_align = []
        else:
            cigar_to_align.append(ce)
    new_cigar.extend(cigar_to_align)
    while new_cigar and new_cigar[0][0] == 0:
        new_cigar.pop(0)
    merged: List[CigOp] = []
    for ln, op in new_cigar:
        if ln == 0:
            continue
        if merged and merged[-1][1] == op:
            merged[-1] = (merged[-1][0] + ln, op)
        else:
            merged.append((ln, op))
    return merged


def calculate_cigar(reference: bytes, alternate: bytes, padded_ref: bytes,
                    strategy: int) -> Optional[List[CigOp]]:
    """Haplotype-vs-reference CIGAR (reference: sw.go:388-412)."""
    if len(reference) == len(alternate):
        mismatches = sum(1 for a, b in zip(reference, alternate) if a != b)
        if mismatches <= 2:
            return [(len(reference), "M")]
    padded_alt = SW_PAD + alternate + SW_PAD
    cigar, alignment_offset = run_smith_waterman(
        padded_ref, padded_alt, *HAP_SW_PARAMS, strategy
    )
    if is_sw_failure(cigar, alignment_offset):
        return None
    base_start = len(SW_PAD)
    base_end = len(padded_alt) - len(SW_PAD) - 1
    non_standard = trim_cigar_by_bases(cigar, base_start, base_end)
    ref_len = reference_length(non_standard)
    if ref_len != len(reference):
        non_standard = non_standard + [(len(reference) - ref_len, "D")]
    return left_align_cigar_sequentially(non_standard, reference, alternate)
