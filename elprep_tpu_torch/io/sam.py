"""SAM text parsing and formatting into/out of columnar ReadBatches.

Replicates the reference's SAM alignment-line parser and formatter
byte-for-byte (reference: sam/sam-files.go:179-598):

- CIGAR strings are normalized: lowercase ops uppercased and *adjacent
  equal operations merged* (sam/sam-types.go:700-724);
- SEQ characters outside "=ACMGRSVTWYHKDBN" (including lowercase and '*')
  become 'N' (sam/sam-types.go:227-236, sam/sam-files.go:356-372);
- QUAL is stored as raw Phred (ASCII - 33) (sam/sam-files.go:400-403);
- RNEXT prints as "=" whenever it equals RNAME (sam/sam-files.go:570-581);
- optional fields are re-emitted canonically: ints re-formatted in base 10,
  floats in Go shortest-'g' float32 form, H arrays as lowercase hex,
  B:s values parsed as uint16 then printed as int16 — all matching
  sam/sam-files.go:319-345 + 485-546 including its quirks.

This module is the correctness-first host path; a C++ tokenizer with the
same contract lives in elprep_tpu_torch/native for throughput.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.batch import Ragged, ReadBatch, TagsColumn
from ..core.header import Header, format_sam_header, parse_sam_header
from .gofmt import go_format_float32

# SEQ normalization table (reference: sam/sam-types.go:227-236).
_SEQ_ALPHABET = b"=ACMGRSVTWYHKDBN"
_SEQ_TRANS = bytes(
    (c if c in _SEQ_ALPHABET else ord("N")) for c in range(256)
)

# nibble encoding order as in the BAM format
SEQ_NIBBLE = {b: i for i, b in enumerate(_SEQ_ALPHABET)}

_SEQ_TRANS_LUT = np.frombuffer(_SEQ_TRANS, np.uint8)

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=XmidnshpxX])")
_CIGAR_OPS_VALID = set(b"MmIiDdNnSsHhPpXx=")


def _parse_cigar(cigar: bytes) -> Tuple[List[int], List[int]]:
    """Parse a CIGAR string into (lengths, op-chars), uppercasing ops and
    merging adjacent equal ops (reference: sam/sam-types.go:700-724)."""
    if cigar == b"*":
        return [], []
    lens: List[int] = []
    ops: List[int] = []
    pos = 0
    n = len(cigar)
    while pos < n:
        m = _CIGAR_RE.match(cigar, pos)
        if m is None:
            raise ValueError(f"invalid CIGAR operation in {cigar!r}")
        length = int(m.group(1))
        op = m.group(2).upper()[0]
        if ops and ops[-1] == op:
            lens[-1] += length
        else:
            lens.append(length)
            ops.append(op)
        pos = m.end()
    return lens, ops


def parse_sam(data: bytes) -> Tuple[Header, ReadBatch]:
    """Parse a complete SAM file (bytes) into (Header, ReadBatch)."""
    hdr, pos = parse_sam_header(data)
    batch = parse_alignments(data, pos)
    return hdr, batch


def parse_alignments(data: bytes, start: int = 0) -> ReadBatch:
    """Parse alignment lines (reference: sam/sam-files.go:386-410).
    Dispatches to the native-tokenizer fast path when available."""
    from .. import native

    if native.available():
        out = _parse_alignments_fast(data, start)
        if out is not None:
            return out
    return _parse_alignments_py(data, start)


def _ranged_gather(u8: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> Ragged:
    from .. import native

    fast = native.ranged_gather_u8(u8, starts, ends)
    if fast is not None:
        return Ragged(fast[0], fast[1])
    lens = (ends - starts).astype(np.int64)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    if total == 0:
        return Ragged(np.zeros(0, u8.dtype), off)
    idx = np.repeat(starts - off[:-1], lens) + np.arange(total, dtype=np.int64)
    return Ragged(u8[idx], off)


_CIGAR_OP_VALID = np.zeros(256, bool)
for _c in b"MIDNSHP=XmidnshpxX":
    _CIGAR_OP_VALID[_c] = True
_CIGAR_UPPER = np.arange(256, dtype=np.uint8)
for _c in b"midnshpx":
    _CIGAR_UPPER[_c] = _c - 32


def _parse_cigars_vectorized(cig: Ragged):
    """Flat-vectorized CIGAR parse of all rows at once. Returns
    (cigar_len Ragged int32, cigar_op Ragged uint8) or None if any row
    needs the scalar path (adjacent-equal merge)."""
    data = cig.data
    n_rows = len(cig)
    if len(data) == 0:
        z = np.zeros(n_rows + 1, np.int64)
        return Ragged(np.zeros(0, np.int32), z), Ragged(np.zeros(0, np.uint8), z)
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), cig.lengths.astype(np.int64))
    is_digit = (data >= ord("0")) & (data <= ord("9"))
    is_star = data == ord("*")
    star_rows = np.zeros(n_rows, bool)
    # '*' rows must be exactly length-1
    star_rows_idx = row_of[is_star]
    star_rows[star_rows_idx] = True
    if star_rows.any():
        bad = star_rows & (cig.lengths != 1)
        if bad.any():
            raise ValueError("invalid CIGAR operation")
    op_mask = ~is_digit & ~is_star
    if not np.all(_CIGAR_OP_VALID[data[op_mask]]):
        raise ValueError("invalid CIGAR operation")
    op_pos = np.flatnonzero(op_mask)
    op_row = row_of[op_pos]
    # every non-star row must end with an op and alternate digits/ops;
    # verify each op is preceded by >=1 digit within the row
    prev_op = np.concatenate([[-1], op_pos[:-1]])
    seg_start = np.maximum(prev_op + 1, cig.offsets[op_row])
    ndig = op_pos - seg_start
    if (ndig < 1).any():
        raise ValueError("invalid CIGAR operation")
    # rows must end at an op, positionally: the row's last op must sit on
    # its final byte (else trailing digits like '4M2' would be dropped)
    row_end_ok = np.zeros(n_rows, bool)
    if len(op_pos):
        last_op_sel = np.concatenate([op_row[1:] != op_row[:-1], [True]])
        row_end_ok[op_row[last_op_sel]] = (
            op_pos[last_op_sel] == cig.offsets[op_row[last_op_sel] + 1] - 1)
    # (an all-'*' input — e.g. an sfm unmapped-reads split file — has no
    # ops at all; every row is a star row and the check below is vacuous)
    nonstar = ~star_rows
    if not np.all(row_end_ok[nonstar] | (cig.lengths[nonstar] == 0)):
        raise ValueError("invalid CIGAR operation")
    # parse lengths: up to 9 digits
    max_d = int(ndig.max()) if len(ndig) else 0
    if max_d > 9:
        return None
    vals = np.zeros(len(op_pos), np.int64)
    for k in range(max_d):
        p = op_pos - 1 - k
        valid = (p >= seg_start)
        d = np.where(valid, data[np.maximum(p, 0)] - ord("0"), 0)
        vals += d.astype(np.int64) * (10 ** k) * valid
    ops = _CIGAR_UPPER[data[op_pos]]
    # adjacent-equal ops within a row need merging: rare; bail out
    same_row = np.concatenate([[False], op_row[1:] == op_row[:-1]])
    if np.any(same_row & np.concatenate([[False], ops[1:] == ops[:-1]])):
        return None
    ops_per_row = np.bincount(op_row, minlength=n_rows)
    off = np.zeros(n_rows + 1, np.int64)
    np.cumsum(ops_per_row, out=off[1:])
    return Ragged(vals.astype(np.int32), off), Ragged(ops.astype(np.uint8), off)


def _parse_alignments_fast(data: bytes, start: int) -> "ReadBatch | None":
    from .. import native

    tok = native.sam_tokenize(data, start)
    if tok is None:
        return None
    n, cols, (f_start, f_end) = tok
    u8 = np.frombuffer(data, np.uint8)
    if n == 0:
        return ReadBatch.empty()

    qname_rg = _ranged_gather(u8, f_start[0], f_end[0])
    w = max(int(qname_rg.lengths.max(initial=1)), 1)
    qname_pad, _ = qname_rg.to_padded(w)
    qnames = qname_pad.view(f"S{w}").reshape(n)

    # interning of rname/rnext in first-appearance order
    rn_rg = _ranged_gather(u8, f_start[1], f_end[1])
    rx_rg = _ranged_gather(u8, f_start[3], f_end[3])
    wname = max(int(rn_rg.lengths.max(initial=1)), int(rx_rg.lengths.max(initial=1)), 1)
    rn_pad, _ = rn_rg.to_padded(wname)
    rx_pad, _ = rx_rg.to_padded(wname)
    both = np.concatenate([rn_pad.view(f"S{wname}").reshape(n),
                           rx_pad.view(f"S{wname}").reshape(n)])
    # run-collapse before unique: rname is clustered in real files and
    # rnext is mostly "=", so the 2n-string array has few value runs —
    # sorting the run representatives replaces a full 2n string sort
    # (profiled ~0.4-0.8 s at 1M reads; degenerates gracefully when
    # unclustered). Results are identical: np.unique of the run values
    # with the inverse re-expanded over the runs.
    seg_starts = np.concatenate(
        [[0], np.flatnonzero(both[1:] != both[:-1]) + 1]).astype(np.int64)
    seg_lens = np.diff(np.append(seg_starts, 2 * n))
    uniq, inv_small = np.unique(both[seg_starts], return_inverse=True)
    inv = np.repeat(inv_small, seg_lens)
    # reorder pool to first appearance (matches the reference's interning)
    first_pos = np.full(len(uniq), 2 * n, np.int64)
    np.minimum.at(first_pos, inv, np.arange(2 * n))
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    inv = rank[inv]
    names = [uniq[order[i]] for i in range(len(uniq))]
    rname_ids = inv[:n].astype(np.int32)
    rnext_ids = inv[n:].astype(np.int32)

    cig_rg = _ranged_gather(u8, f_start[2], f_end[2])
    parsed = _parse_cigars_vectorized(cig_rg)
    if parsed is None:
        return None  # rare merge case: fall back entirely
    cigar_len, cigar_op = parsed

    seq_rg = _ranged_gather(u8, f_start[4], f_end[4])
    # LUT gather, not bytes.translate: the tobytes+translate round trip
    # materialized two whole-column Python bytes objects through glibc
    # malloc (outside the npalloc warm cache — ~6 s of fresh-page
    # faults at 4M reads on this host class)
    seq_rg = Ragged(_SEQ_TRANS_LUT[seq_rg.data], seq_rg.offsets)
    qual_rg = _ranged_gather(u8, f_start[5], f_end[5])
    qual_rg.data -= np.uint8(33)  # owned by the gather: offset in place
    tags_rg = _ranged_gather(u8, f_start[6], f_end[6])

    return ReadBatch(
        qname=qnames,
        flag=cols["flag"],
        rname_id=rname_ids,
        pos=cols["pos"],
        mapq=cols["mapq"],
        cigar_len=cigar_len,
        cigar_op=cigar_op,
        rnext_id=rnext_ids,
        pnext=cols["pnext"],
        tlen=cols["tlen"],
        seq=seq_rg,
        qual=qual_rg,
        tags=TagsColumn(tags_rg),
        names=names,
    )


def _parse_alignments_py(data: bytes, start: int = 0) -> ReadBatch:
    """Pure-Python parser (reference semantics, fallback path)."""
    body = data[start:]
    if body.endswith(b"\n"):
        body = body[:-1]
    lines = body.split(b"\n") if body else []
    n = len(lines)

    qnames: List[bytes] = []
    flags = np.zeros(n, np.int32)
    rname_ids = np.zeros(n, np.int32)
    poss = np.zeros(n, np.int32)
    mapqs = np.zeros(n, np.int32)
    rnext_ids = np.zeros(n, np.int32)
    pnexts = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    cigar_lens: List[np.ndarray] = []
    cigar_ops: List[np.ndarray] = []
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    tag_rows: List[bytes] = []
    pool: Dict[bytes, int] = {}

    for i, line in enumerate(lines):
        fields = line.split(b"\t")
        if len(fields) < 11:
            raise ValueError(f"missing tabulator in SAM alignment line: {line!r}")
        qnames.append(fields[0])
        flags[i] = int(fields[1])
        rname = fields[2]
        rname_ids[i] = pool.setdefault(rname, len(pool))
        poss[i] = int(fields[3])
        mapqs[i] = int(fields[4])
        cl, co = _parse_cigar(fields[5])
        cigar_lens.append(np.array(cl, np.int32))
        cigar_ops.append(np.array(co, np.uint8))
        rnext_ids[i] = pool.setdefault(fields[6], len(pool))
        pnexts[i] = int(fields[7])
        tlens[i] = int(fields[8])
        seqs.append(np.frombuffer(fields[9].translate(_SEQ_TRANS), np.uint8))
        qual = np.frombuffer(fields[10], np.uint8)
        quals.append((qual - np.uint8(33)).astype(np.uint8))
        tag_rows.append(b"\t".join(fields[11:]))

    names: List[bytes] = [None] * len(pool)
    for nm, idx in pool.items():
        names[idx] = nm
    return ReadBatch(
        qname=np.array(qnames, dtype=bytes) if qnames else np.array([], dtype="S1"),
        flag=flags,
        rname_id=rname_ids,
        pos=poss,
        mapq=mapqs,
        cigar_len=Ragged.from_rows(cigar_lens, np.int32),
        cigar_op=Ragged.from_rows(cigar_ops, np.uint8),
        rnext_id=rnext_ids,
        pnext=pnexts,
        tlen=tlens,
        seq=Ragged.from_rows(seqs, np.uint8),
        qual=Ragged.from_rows(quals, np.uint8),
        tags=TagsColumn.from_rows(tag_rows),
        names=names,
    )


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------


def canonicalize_tag_field(field_: bytes) -> bytes:
    """Re-emit one optional field exactly as elPrep would after its
    parse/format round trip (reference: sam/sam-files.go:186-345, 485-546)."""
    tag = field_[:2]
    typ = field_[3:4]
    val = field_[5:]
    if typ == b"A" or typ == b"Z":
        return field_
    if typ == b"i":
        return tag + b":i:" + b"%d" % int(val)
    if typ == b"f":
        return tag + b":f:" + go_format_float32(float(val)).encode()
    if typ == b"H":
        out = bytearray(tag + b":H:")
        for j in range(0, len(val) & ~1, 2):
            out += b"%02x" % int(val[j : j + 2], 16)
        return bytes(out)
    if typ == b"B":
        sub = val[:1]
        entries = val[2:].split(b",") if len(val) > 1 else []
        out = bytearray(tag + b":B:" + sub)
        if sub == b"c":
            for e in entries:
                out += b",%d" % np.int8(int(e))
        elif sub == b"C":
            for e in entries:
                out += b",%d" % np.uint8(int(e))
        elif sub == b"s":
            # quirk: parsed as uint16, printed as int16
            # (reference: sam/sam-files.go:263-272); bit-cast so that
            # already-negative values (from BAM binary int16) pass through
            for e in entries:
                v = int(e) & 0xFFFF
                out += b",%d" % (v - 0x10000 if v >= 0x8000 else v)
        elif sub == b"S":
            for e in entries:
                out += b",%d" % np.uint16(int(e))
        elif sub == b"i":
            for e in entries:
                out += b",%d" % np.int32(int(e))
        elif sub == b"I":
            for e in entries:
                out += b",%d" % np.uint32(int(e))
        elif sub == b"f":
            for e in entries:
                out += b"," + go_format_float32(float(e)).encode()
        else:
            raise ValueError(f"invalid numeric array type {sub!r}")
        return bytes(out)
    raise ValueError(f"unknown SAM tag type {typ!r} in {field_!r}")


def format_alignment_line(batch: ReadBatch, i: int, names_pool: np.ndarray) -> bytes:
    """Format read i (reference: sam/sam-files.go:563-598)."""
    out = bytearray()
    out += batch.qname[i]
    out += b"\t%d\t" % batch.flag[i]
    rname = names_pool[batch.rname_id[i]]
    out += rname
    out += b"\t%d\t%d\t" % (batch.pos[i], batch.mapq[i])
    cl = batch.cigar_len.row(i)
    co = batch.cigar_op.row(i)
    if len(cl) == 0:
        out += b"*"
    else:
        for k in range(len(cl)):
            out += b"%d%c" % (cl[k], co[k])
    out += b"\t"
    rnext = names_pool[batch.rnext_id[i]]
    if rnext == b"=" or rnext == b"*":
        out += rnext
    elif rnext == rname:
        out += b"="
    else:
        out += rnext
    out += b"\t%d\t%d\t" % (batch.pnext[i], batch.tlen[i])
    out += batch.seq.row(i).tobytes()
    out += b"\t"
    out += (batch.qual.row(i) + np.uint8(33)).tobytes()
    raw_tags = batch.tags.row(i)
    if raw_tags:
        for f in raw_tags.split(b"\t"):
            out += b"\t"
            out += canonicalize_tag_field(f)
    out += b"\n"
    return bytes(out)


def format_alignments(batch: ReadBatch) -> bytes:
    from .. import native

    if len(batch) > 256 and native.available():
        fast = native.sam_format_alignments(
            batch.qname, batch.flag, batch.rname_id, batch.pos, batch.mapq,
            batch.cigar_len.data, batch.cigar_op.data, batch.cigar_len.offsets,
            batch.rnext_id, batch.pnext, batch.tlen,
            batch.seq.data, batch.seq.offsets,
            batch.qual.data, batch.qual.offsets,
            batch.tags.raw.data, batch.tags.raw.offsets, batch.names)
        if fast is not None:
            return fast.tobytes()
    pool = np.array(batch.names, dtype=bytes) if batch.names else np.array([b""], dtype=bytes)
    out = bytearray()
    for i in range(len(batch)):
        out += format_alignment_line(batch, i, pool)
    return bytes(out)


def format_sam(hdr: Header, batch: ReadBatch) -> bytes:
    return format_sam_header(hdr) + format_alignments(batch)


# ---------------------------------------------------------------------------
# Streaming chunk reader (reference's constant-memory fast path,
# sam/filter-pipeline.go:282-296 + README.md:130-132)
# ---------------------------------------------------------------------------


def iter_sam_chunks(path: str, chunk_bytes: int = 64 << 20):
    """Yield (header, batch) pairs streaming a SAM text file in chunks;
    header is parsed once and repeated with every chunk. BAM/gzip inputs
    fall back to one whole-file chunk."""
    with open(path, "rb") as f:
        # seek-free so pipes (/dev/stdin) work (reference: aln-files.go:144-251)
        head = f.read(1)
        if head == b"\x1f":  # BAM/BGZF: streaming block reader
            from . import bam

            yield from bam.iter_bam_chunks(f, head=head, chunk_bytes=chunk_bytes)
            return
        # read header lines; the first non-@ line becomes the initial carry
        header_buf = bytearray()
        carry = b""
        first = True
        while True:
            line = f.readline()
            if first:
                line = head + line
                first = False
            if not line:
                break
            if line.startswith(b"@"):
                header_buf += line
            else:
                carry = line
                break
        hdr, _ = parse_sam_header(bytes(header_buf))
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if carry:
                    yield hdr, parse_alignments(carry)
                break
            chunk = carry + chunk
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                carry = chunk
                continue
            carry = chunk[last_nl + 1 :]
            yield hdr, parse_alignments(chunk[: last_nl + 1])


# ---------------------------------------------------------------------------
# File-level API with content sniffing (reference: sam/aln-files.go:144-251)
# ---------------------------------------------------------------------------


def read_sam_file(path: str) -> Tuple[Header, ReadBatch]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"\x1f":  # gzip magic: BAM/BGZF content
        from . import bam

        return bam.parse_bam(data)
    return parse_sam(data)


def write_sam_file(path: str, hdr: Header, batch: ReadBatch, fmt: str = "sam") -> None:
    if fmt == "bam":
        from . import bam

        with open(path, "wb") as f:
            f.write(bam.format_bam(hdr, batch))
        return
    with open(path, "wb") as f:
        f.write(format_sam(hdr, batch))
