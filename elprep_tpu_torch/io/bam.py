"""BAM binary I/O into/out of columnar ReadBatches.

Replicates the reference's BAM record semantics
(reference: sam/bam-files.go:317-400 parse, :443-468 bin, :635-737
format) on top of the parallel BGZF codec:

- refID < 0 parses as RNAME "*"; RNEXT equal to RNAME is stored as "="
  (bam-files.go:320-347);
- POS/PNEXT are stored +1 (1-based in the data model);
- integer tags of any BAM width parse to plain integers and are written
  back as the smallest fitting type c/C/s/S/i/I (bam-files.go:491-526);
- a CG:B:I tag replaces a placeholder "<lseq>S" CIGAR on parse, and
  CIGARs with more than 65535 ops are written as the placeholder plus a
  CG tag (bam-files.go:378-397, 659-707, 721-731);
- bin() is the UCSC binning of [POS-1, end) (bam-files.go:443-468).

Fixed-width record fields parse/format fully vectorized over numpy; only
optional-field (tag) conversion runs per record.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.batch import Ragged, ReadBatch, TagsColumn
from ..core.header import Header, format_sam_header, parse_sam_header
from . import bgzf
from .gofmt import go_format_float32

BAM_MAGIC = b"BAM\x01"

CIGAR_OPS = b"MIDNSHP=X"
_CIGAR_OP_TO_NUM = {op: i for i, op in enumerate(CIGAR_OPS)}
_CIGAR_NUM_TO_OP = np.frombuffer(CIGAR_OPS, np.uint8)
_CIGAR_ASCII_TO_NUM = np.zeros(256, np.uint32)
for _op, _i in _CIGAR_OP_TO_NUM.items():
    _CIGAR_ASCII_TO_NUM[_op] = _i

SEQ_ALPHABET = b"=ACMGRSVTWYHKDBN"
_NIBBLE_TO_CHAR = np.frombuffer(SEQ_ALPHABET, np.uint8)
_CHAR_TO_NIBBLE = np.zeros(256, np.uint8)
for _i, _c in enumerate(SEQ_ALPHABET):
    _CHAR_TO_NIBBLE[_c] = _i

# ops that consume reference bases, as ASCII lookup (bam-files.go:441)
_REF_CONSUME = np.zeros(256, np.int64)
for _c in b"MDN=X":
    _REF_CONSUME[_c] = 1

UNMAPPED = 0x4


def _ragged_gather(src: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> Ragged:
    """Gather variable-length rows from a flat buffer (no Python loop)."""
    lengths = lengths.astype(np.int64)
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    total = int(off[-1])
    if total == 0:
        return Ragged(np.zeros(0, src.dtype), off)
    idx = np.repeat(starts.astype(np.int64) - off[:-1], lengths) + np.arange(total, dtype=np.int64)
    return Ragged(src[idx], off)


# ---------------------------------------------------------------------------
# Tag conversion: BAM binary <-> canonical SAM text (TagsColumn rows)
# ---------------------------------------------------------------------------

_INT_FMT = {
    ord("c"): ("<b", 1), ord("C"): ("<B", 1),
    ord("s"): ("<h", 2), ord("S"): ("<H", 2),
    ord("i"): ("<i", 4), ord("I"): ("<I", 4),
}
_ARRAY_DTYPE = {
    ord("c"): np.int8, ord("C"): np.uint8,
    ord("s"): np.int16, ord("S"): np.uint16,
    ord("i"): np.int32, ord("I"): np.uint32,
    ord("f"): np.dtype("<f4"),
}


def _bam_tags_to_text(
    rec: memoryview, start: int, end: int, lseq: int, ncig: int
) -> Tuple[bytes, Optional[np.ndarray]]:
    """Convert one record's binary tags to canonical SAM text.

    Returns (text, cg_cigar_or_None) where cg_cigar is the raw uint32
    CIGAR from a consumed CG tag (bam-files.go:378-397)."""
    fields: List[bytes] = []
    cg: Optional[np.ndarray] = None
    i = start
    while i < end:
        tag = bytes(rec[i : i + 2])
        typ = rec[i + 2]
        i += 3
        if typ == ord("A"):
            fields.append(tag + b":A:" + bytes(rec[i : i + 1]))
            i += 1
        elif typ in _INT_FMT:
            fmt, size = _INT_FMT[typ]
            val = struct.unpack_from(fmt, rec, i)[0]
            fields.append(tag + b":i:%d" % val)
            i += size
        elif typ == ord("f"):
            val = struct.unpack_from("<f", rec, i)[0]
            fields.append(tag + b":f:" + go_format_float32(val).encode())
            i += 4
        elif typ == ord("Z"):
            j = i
            while rec[j]:
                j += 1
            fields.append(tag + b":Z:" + bytes(rec[i:j]))
            i = j + 1
        elif typ == ord("H"):
            j = i
            while rec[j]:
                j += 1
            raw = bytes(rec[i:j])
            # hex text in BAM -> bytes -> canonical lowercase hex
            fields.append(tag + b":H:" + bytes.fromhex(raw.decode()).hex().encode())
            i = j + 1
        elif typ == ord("B"):
            sub = rec[i]
            count = struct.unpack_from("<i", rec, i + 1)[0]
            i += 5
            dt = _ARRAY_DTYPE[sub]
            vals = np.frombuffer(rec, dt, count, i)
            i += count * dt.itemsize if isinstance(dt, np.dtype) else count * np.dtype(dt).itemsize
            if tag == b"CG" and sub == ord("I"):
                # candidate long-CIGAR tag; caller decides (bam-files.go:380-391)
                cg = vals.astype(np.uint32)
                continue
            body = tag + b":B:" + bytes([sub])
            if sub == ord("f"):
                for v in vals:
                    body += b"," + go_format_float32(float(v)).encode()
            else:
                body += b"".join(b",%d" % v for v in vals)
            fields.append(body)
        else:
            raise ValueError(f"invalid field type {chr(typ)!r} in BAM record")
    return b"\t".join(fields), cg


def _text_tags_to_bam(row: bytes) -> bytes:
    """Convert one read's canonical SAM tag text to BAM binary
    (reference: formatBamTag, bam-files.go:481-633)."""
    if not row:
        return b""
    out = bytearray()
    for field_ in row.split(b"\t"):
        tag = field_[:2]
        typ = field_[3:4]
        val = field_[5:]
        out += tag
        if typ == b"A":
            out += b"A" + val[:1]
        elif typ == b"i":
            v = int(val)
            if v < 0:
                if v >= -(1 << 7):
                    out += struct.pack("<cb", b"c", v)
                elif v >= -(1 << 15):
                    out += struct.pack("<ch", b"s", v)
                elif v >= -(1 << 31):
                    out += struct.pack("<ci", b"i", v)
                else:
                    raise ValueError("integer value too small in BAM alignment tag")
            else:
                if v <= 0xFF:
                    out += struct.pack("<cB", b"C", v)
                elif v <= 0xFFFF:
                    out += struct.pack("<cH", b"S", v)
                elif v <= 0xFFFFFFFF:
                    out += struct.pack("<cI", b"I", v)
                else:
                    raise ValueError("integer value too large in BAM alignment tag")
        elif typ == b"f":
            out += struct.pack("<cf", b"f", float(val))
        elif typ == b"Z":
            out += b"Z" + val + b"\x00"
        elif typ == b"H":
            # canonical text is lowercase hex; BAM uses uppercase (bam-files.go:536-556)
            out += b"H" + val.upper() + b"\x00"
        elif typ == b"B":
            sub = val[:1]
            entries = val[2:].split(b",") if len(val) > 1 else []
            out += b"B" + sub + struct.pack("<i", len(entries))
            dt = _ARRAY_DTYPE[sub[0]]
            arr = (
                np.array([float(e) for e in entries], dt)
                if sub == b"f"
                else np.array([int(e) for e in entries]).astype(dt)
            )
            out += arr.tobytes()
        else:
            raise ValueError(f"unknown SAM tag type {typ!r}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


def parse_bam_header_raw(raw: bytes) -> Tuple[Header, List[Tuple[bytes, int]], int]:
    """Parse magic + header text + references from decompressed bytes.
    Returns (header, [(name, length)], offset past the header section)."""
    if raw[:4] != BAM_MAGIC:
        raise ValueError("did not find BAM magic sequence")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8 : 8 + l_text].rstrip(b"\x00")
    hdr, _ = parse_sam_header(text)
    pos = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, pos)[0]
    pos += 4
    refs: List[Tuple[bytes, int]] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, pos)[0]
        name = raw[pos + 4 : pos + 4 + l_name - 1]
        l_ref = struct.unpack_from("<i", raw, pos + 4 + l_name)[0]
        refs.append((name, l_ref))
        pos += 8 + l_name
    return hdr, refs, pos


def parse_bam(data: bytes) -> Tuple[Header, ReadBatch]:
    """Parse a complete BGZF-compressed BAM byte buffer."""
    raw = bgzf.decompress(data)
    hdr, refs, pos = parse_bam_header_raw(raw)
    batch = parse_bam_records(raw, refs, pos)
    return hdr, batch


def _try_parse_bam_header(raw: bytes):
    """parse_bam_header_raw that returns None while ``raw`` is still an
    incomplete prefix of the header section (streaming reads)."""
    if len(raw) < 12:
        return None
    if raw[:4] != BAM_MAGIC:
        raise ValueError("did not find BAM magic sequence")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    pos = 8 + l_text
    if len(raw) < pos + 4:
        return None
    n_ref = struct.unpack_from("<i", raw, pos)[0]
    pos += 4
    for _ in range(n_ref):
        if len(raw) < pos + 4:
            return None
        l_name = struct.unpack_from("<i", raw, pos)[0]
        if len(raw) < pos + 8 + l_name:
            return None
        pos += 8 + l_name
    return parse_bam_header_raw(raw)


def _records_complete_prefix(raw: bytes, start: int) -> int:
    """Length-prefix walk: end offset of the last whole record in ``raw``
    (reference framing: bamReader.Fetch, bam-files.go:780-800)."""
    pos = start
    n = len(raw)
    unpack = struct.unpack_from
    while pos + 4 <= n:
        size = unpack("<i", raw, pos)[0]
        if size < 0 or pos + 4 + size > n:
            break
        pos += 4 + size
    return pos


def iter_bam_chunks(f, head: bytes = b"", chunk_bytes: int = 64 << 20):
    """Yield (header, batch) pairs streaming a BGZF BAM file in bounded
    memory: incremental block decompression (io.bgzf.iter_bgzf_chunks)
    plus length-prefixed record framing, the streaming structure of the
    reference reader (bam-files.go:780-800, bgzf-files.go:95-265)."""
    hdr = None
    refs: List[Tuple[bytes, int]] = []
    buf = b""
    for chunk in bgzf.iter_bgzf_chunks(f, head=head):
        buf += chunk
        if hdr is None:
            parsed = _try_parse_bam_header(buf)
            if parsed is None:
                continue
            hdr, refs, start = parsed
            buf = buf[start:]
        if len(buf) >= chunk_bytes:
            end = _records_complete_prefix(buf, 0)
            if end:
                yield hdr, parse_bam_records(buf[:end], refs, 0)
                buf = buf[end:]
    if hdr is None:
        hdr, refs, start = parse_bam_header_raw(buf)
        buf = buf[start:]
    yield hdr, parse_bam_records(buf, refs, 0)


def parse_bam_records(raw: bytes, refs: List[Tuple[bytes, int]], start: int) -> ReadBatch:
    u8 = np.frombuffer(raw, np.uint8)
    n_total = len(raw)

    # serial framing: record offsets from the length-prefix chain
    # (reference: bamReader.Fetch, bam-files.go:780-800)
    offs: List[int] = []
    pos = start
    unpack = struct.unpack_from
    while pos < n_total:
        size = unpack("<i", raw, pos)[0]
        offs.append(pos + 4)
        pos += 4 + size
    n = len(offs)
    offsets = np.array(offs, np.int64)
    rec_ends = np.empty(n, np.int64)
    rec_ends[:-1] = offsets[1:] - 4
    if n:
        rec_ends[-1] = n_total

    if n == 0:
        batch = ReadBatch.empty()
        batch.names = [nm for nm, _ in refs]
        return batch

    # fixed 32-byte field block, vectorized
    fixed = np.ascontiguousarray(u8[offsets[:, None] + np.arange(32)])
    words = fixed.view(np.int32).reshape(n, 8)
    ref_id = words[:, 0]
    pos0 = words[:, 1]
    l_read_name = fixed[:, 8].astype(np.int64)
    mapq = fixed[:, 9].astype(np.int32)
    n_cigar = fixed.view(np.uint16).reshape(n, 16)[:, 6].astype(np.int64)
    flag = fixed.view(np.uint16).reshape(n, 16)[:, 7].astype(np.int32)
    l_seq = words[:, 4].astype(np.int64)
    next_ref_id = words[:, 5]
    next_pos = words[:, 6]
    tlen = words[:, 7]

    qname_starts = offsets + 32
    qname_rg = _ragged_gather(u8, qname_starts, l_read_name - 1)
    lens = qname_rg.lengths
    maxw = max(int(lens.max()), 1) if n else 1
    qname_pad, _ = qname_rg.to_padded(maxw)
    qnames = qname_pad.view(f"S{maxw}").reshape(n)

    cigar_starts = qname_starts + l_read_name
    cigar_rg = _ragged_gather(u8, cigar_starts, 4 * n_cigar)
    cigar_u32 = np.ascontiguousarray(cigar_rg.data).view(np.uint32)
    cigar_len_all = (cigar_u32 >> 4).astype(np.int32)
    cigar_op_all = _CIGAR_NUM_TO_OP[cigar_u32 & 0xF]
    cigar_off = cigar_rg.offsets // 4

    seq_starts = cigar_starts + 4 * n_cigar
    packed_rg = _ragged_gather(u8, seq_starts, (l_seq + 1) >> 1)
    # expand nibbles: each packed byte -> 2 chars, then trim rows to l_seq
    pairs = np.empty((len(packed_rg.data), 2), np.uint8)
    pairs[:, 0] = _NIBBLE_TO_CHAR[packed_rg.data >> 4]
    pairs[:, 1] = _NIBBLE_TO_CHAR[packed_rg.data & 0xF]
    chars2 = pairs.reshape(-1)
    seq_rg = _ragged_gather(chars2, packed_rg.offsets[:-1] * 2, l_seq)

    qual_starts = seq_starts + ((l_seq + 1) >> 1)
    qual_rg = _ragged_gather(u8, qual_starts, l_seq)

    # tags (per record) + CG long-CIGAR substitution
    tag_starts = qual_starts + l_seq
    mv = memoryview(raw)
    tag_rows: List[bytes] = []
    cg_over: Dict[int, np.ndarray] = {}
    for i in range(n):
        ts, te = tag_starts[i], rec_ends[i]
        if ts >= te:
            tag_rows.append(b"")
            continue
        text, cg = _bam_tags_to_text(mv, int(ts), int(te), int(l_seq[i]), int(n_cigar[i]))
        tag_rows.append(text)
        if cg is not None:
            # only substitutes when CIGAR is the <lseq>S placeholder
            o = int(cigar_off[i])
            if (
                n_cigar[i] > 0
                and cigar_op_all[o] == ord("S")
                and cigar_len_all[o] == l_seq[i]
            ):
                cg_over[i] = cg
            else:
                # CG tag not consumed: keep it as a normal tag? The
                # reference silently drops a non-matching CG:B:I
                # (bam-files.go:380-397 `continue` after the check).
                pass

    cigar_len_rows: List[np.ndarray] = []
    cigar_op_rows: List[np.ndarray] = []
    if cg_over:
        for i in range(n):
            if i in cg_over:
                cg = cg_over[i]
                cigar_len_rows.append((cg >> 4).astype(np.int32))
                cigar_op_rows.append(_CIGAR_NUM_TO_OP[cg & 0xF])
            else:
                o, e = int(cigar_off[i]), int(cigar_off[i + 1])
                cigar_len_rows.append(cigar_len_all[o:e])
                cigar_op_rows.append(cigar_op_all[o:e])
        cigar_len = Ragged.from_rows(cigar_len_rows, np.int32)
        cigar_op = Ragged.from_rows(cigar_op_rows, np.uint8)
    else:
        cigar_len = Ragged(cigar_len_all, cigar_off.copy())
        cigar_op = Ragged(cigar_op_all, cigar_off.copy())

    # name pool: reference names + "*" + "="
    names = [nm for nm, _ in refs]
    star_id = len(names)
    eq_id = star_id + 1
    names = names + [b"*", b"="]
    rname_id = np.where(ref_id < 0, star_id, ref_id).astype(np.int32)
    rnext_id = np.where(
        next_ref_id < 0, star_id, np.where(next_ref_id == ref_id, eq_id, next_ref_id)
    ).astype(np.int32)

    return ReadBatch(
        qname=qnames,
        flag=flag,
        rname_id=rname_id,
        pos=pos0 + 1,
        mapq=mapq,
        cigar_len=cigar_len,
        cigar_op=cigar_op,
        rnext_id=rnext_id,
        pnext=next_pos + 1,
        tlen=tlen.astype(np.int32),
        seq=seq_rg,
        qual=qual_rg,
        tags=TagsColumn.from_rows(tag_rows),
        names=names,
    )


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------


def _compute_bins(pos: np.ndarray, flag: np.ndarray, ref_len: np.ndarray) -> np.ndarray:
    """Vectorized UCSC bin (reference: bam-files.go:443-468); ref_len is the
    per-read reference-consumed CIGAR length."""
    beg = (pos - 1).astype(np.int64)
    mapped = (flag & UNMAPPED) == 0
    end = np.where(mapped, beg + ref_len - 1, beg)
    out = np.zeros(len(pos), np.uint16)
    done = np.zeros(len(pos), bool)
    for shift, offset in ((14, (1 << 15) - 1), (17, (1 << 12) - 1), (20, (1 << 9) - 1),
                          (23, (1 << 6) - 1), (26, (1 << 3) - 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = (offset // 7 + (beg[hit] >> shift)).astype(np.uint16)
        done |= hit
    return out


def format_bam_header_raw(hdr: Header) -> bytes:
    """Magic + SAM text + binary reference list (bam-files.go:414-439)."""
    text = format_sam_header(hdr)
    out = bytearray()
    out += BAM_MAGIC
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(hdr.sq))
    for sq in hdr.sq:
        sn = sq["SN"].encode()
        out += struct.pack("<i", len(sn) + 1)
        out += sn + b"\x00"
        out += struct.pack("<i", hdr.sq_ln(sq))
    return bytes(out)


def format_bam_records(hdr: Header, batch: ReadBatch) -> bytes:
    n = len(batch)
    dict_table: Dict[bytes, int] = {b"*": -1}
    for index, entry in enumerate(hdr.sq):
        dict_table[entry["SN"].encode()] = index

    name_to_refid = np.array(
        [dict_table.get(nm, -1) for nm in batch.names] or [-1], np.int32
    )
    ref_id = name_to_refid[batch.rname_id] if n else np.zeros(0, np.int32)
    rnext_names = np.array(batch.names, dtype=bytes) if batch.names else np.array([b""], dtype=bytes)
    is_eq = rnext_names[batch.rnext_id] == b"="
    next_ref_id = np.where(is_eq, ref_id, name_to_refid[batch.rnext_id])

    # qnames live in a fixed-width NUL-padded 'S' array; SAM qnames cannot
    # contain NUL, so non-zero counts give the lengths and a row-major mask
    # gather gives the ragged bytes without a per-read loop
    if n:
        qarr = np.ascontiguousarray(batch.qname)
        qw = max(qarr.dtype.itemsize, 1)
        qmat = qarr.view(np.uint8).reshape(n, qw)
        qmask = qmat != 0
        qname_len = qmask.sum(1).astype(np.int64)
    else:
        qname_len = np.zeros(0, np.int64)
    n_cigar = batch.cigar_len.lengths.astype(np.int64)
    long_cigar = n_cigar > 0xFFFF
    l_seq = batch.seq.lengths.astype(np.int64)

    # reference-consumed length per read, vectorized over the flat CIGAR
    refcons_flat = _REF_CONSUME[batch.cigar_op.data] * batch.cigar_len.data.astype(np.int64)
    refcons_cum = np.concatenate([[0], np.cumsum(refcons_flat)])
    ref_len = refcons_cum[batch.cigar_len.offsets[1:]] - refcons_cum[batch.cigar_len.offsets[:-1]]
    bins = _compute_bins(batch.pos, batch.flag, ref_len)

    from .. import native

    fast_tags = native.sam_tags_to_bam(batch.tags.raw.data, batch.tags.raw.offsets)
    if fast_tags is not None:
        bin_flat, bin_offsets, fallback = fast_tags
        if len(fallback):
            # rows with B-type arrays: convert in Python and splice
            rows = []
            fset = set(fallback.tolist())
            for i in range(n):
                if i in fset:
                    rows.append(np.frombuffer(_text_tags_to_bam(batch.tags.row(i)), np.uint8))
                else:
                    rows.append(bin_flat[bin_offsets[i]:bin_offsets[i + 1]])
            tags_bin = Ragged.from_rows(rows, np.uint8)
        else:
            tags_bin = Ragged(bin_flat, bin_offsets)
        tag_lens = tags_bin.lengths.astype(np.int64)
    else:
        tag_bins = [_text_tags_to_bam(batch.tags.row(i)) for i in range(n)]
        tags_bin = Ragged.from_rows([np.frombuffer(t, np.uint8) for t in tag_bins], np.uint8)
        tag_lens = tags_bin.lengths.astype(np.int64)

    ncig_out = np.where(long_cigar, 2, n_cigar)
    cg_extra = np.where(long_cigar, 8 + 4 * n_cigar, 0)
    sizes = (
        32 + (qname_len + 1) + 4 * ncig_out + ((l_seq + 1) >> 1) + l_seq
        + tag_lens + cg_extra
    )
    rec_offs = np.zeros(n + 1, np.int64)
    np.cumsum(sizes + 4, out=rec_offs[1:])
    total = int(rec_offs[-1])
    out = np.zeros(total, np.uint8)

    starts = rec_offs[:-1]
    # block_size prefix + fixed fields
    head = np.empty((n, 9), np.int32)
    head[:, 0] = sizes.astype(np.int32)
    head[:, 1] = ref_id
    head[:, 2] = batch.pos - 1
    head[:, 3] = (
        (qname_len + 1).astype(np.int32)
        | (batch.mapq.astype(np.int32) << 8)
        | (bins.astype(np.int32) << 16)
    )
    head[:, 4] = ncig_out.astype(np.int32) | (batch.flag.astype(np.int32) << 16)
    head[:, 5] = l_seq.astype(np.int32)
    head[:, 6] = next_ref_id
    head[:, 7] = batch.pnext - 1
    head[:, 8] = batch.tlen
    head_u8 = head.view(np.uint8).reshape(n, 36)
    out[(starts[:, None] + np.arange(36))] = head_u8

    # qname + NUL (the NUL terminator is the zero-initialized out byte)
    qn_starts = starts + 36
    if n:
        qn_off = np.zeros(n + 1, np.int64)
        np.cumsum(qname_len, out=qn_off[1:])
        qn_rg = Ragged(qmat[qmask], qn_off)
    else:
        qn_rg = Ragged(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    _scatter_ragged(out, qn_starts, qn_rg)

    # CIGAR (normal-length reads vectorized)
    cigar_starts = qn_starts + qname_len + 1
    cigar_words = (
        (batch.cigar_len.data.astype(np.uint32) << 4)
        | _CIGAR_ASCII_TO_NUM[batch.cigar_op.data]
    )
    if not long_cigar.any():
        cig_rg = Ragged(
            np.ascontiguousarray(cigar_words).view(np.uint8),
            batch.cigar_len.offsets * 4,
        )
        _scatter_ragged(out, cigar_starts, cig_rg)
    else:
        for i in range(n):
            o, e = batch.cigar_len.offsets[i], batch.cigar_len.offsets[i + 1]
            if long_cigar[i]:
                words = np.array(
                    [(l_seq[i] << 4) | _CIGAR_OP_TO_NUM[ord("S")],
                     (ref_len[i] << 4) | _CIGAR_OP_TO_NUM[ord("N")]],
                    np.uint32,
                )
            else:
                words = cigar_words[o:e]
            b = np.ascontiguousarray(words).view(np.uint8)
            out[cigar_starts[i] : cigar_starts[i] + len(b)] = b

    # SEQ nibbles
    seq_starts = cigar_starts + 4 * ncig_out
    seq_off = batch.seq.offsets
    packed_len = (l_seq + 1) >> 1
    packed_off = np.zeros(n + 1, np.int64)
    np.cumsum(packed_len, out=packed_off[1:])
    packed = native.pack_nibbles(batch.seq.data, seq_off, _CHAR_TO_NIBBLE,
                                 packed_off)
    if packed is None:
        nib = _CHAR_TO_NIBBLE[batch.seq.data]
        # indices of the hi/lo nibble source for every packed byte
        pb_row = np.repeat(np.arange(n), packed_len)
        pb_in_row = np.arange(int(packed_off[-1])) - np.repeat(packed_off[:-1], packed_len)
        hi_src = seq_off[:-1][pb_row] + 2 * pb_in_row
        lo_src = hi_src + 1
        lo_valid = (2 * pb_in_row + 1) < l_seq[pb_row]
        packed = ((nib[hi_src] << 4) | np.where(
            lo_valid, nib[np.minimum(lo_src, len(nib) - 1)], 0)).astype(np.uint8)
    _scatter_ragged(out, seq_starts, Ragged(packed, packed_off))

    # QUAL
    qual_starts = seq_starts + packed_len
    _scatter_ragged(out, qual_starts, batch.qual)

    # tags (ragged scatter; long-CIGAR escapes patched individually)
    tag_starts = qual_starts + l_seq
    _scatter_ragged(out, tag_starts, tags_bin)
    if long_cigar.any():
        outb = bytearray(out.tobytes())
        for i in np.flatnonzero(long_cigar):
            t = tags_bin.row(i).tobytes()
            o, e = batch.cigar_len.offsets[i], batch.cigar_len.offsets[i + 1]
            cg = bytearray(b"CGBI")
            cg += struct.pack("<i", int(n_cigar[i]))
            cg += np.ascontiguousarray(cigar_words[o:e]).tobytes()
            pos0 = tag_starts[i] + len(t)
            outb[pos0 : pos0 + len(cg)] = cg
        return bytes(outb)
    return out.tobytes()


def _scatter_ragged(out: np.ndarray, starts: np.ndarray, rg: Ragged) -> None:
    from .. import native

    if rg.data.dtype == np.uint8 and out.dtype == np.uint8 and \
            native.ranged_scatter_u8(rg.data, rg.offsets, starts, out):
        return
    lens = rg.offsets[1:] - rg.offsets[:-1]
    total = int(rg.offsets[-1])
    if total == 0:
        return
    dst = np.repeat(starts.astype(np.int64) - rg.offsets[:-1], lens) + np.arange(total, dtype=np.int64)
    out[dst] = rg.data


def format_bam(hdr: Header, batch: ReadBatch, level: int = 6) -> bytes:
    raw = format_bam_header_raw(hdr) + format_bam_records(hdr, batch)
    return bgzf.compress(raw, level=level)


class StreamingBamWriter:
    """Bounded-memory BAM writer, byte-identical to format_bam() on the
    concatenation of the written batches (the BGZF chop happens at the
    same 64 KB payload boundaries)."""

    def __init__(self, fileobj, hdr: Header, level: int = 6):
        self.hdr = hdr
        self.w = bgzf.StreamingBgzfWriter(fileobj, level)
        self.w.write(format_bam_header_raw(hdr))

    def write_batch(self, batch: ReadBatch) -> None:
        if len(batch):
            self.w.write(format_bam_records(self.hdr, batch))

    def close(self) -> None:
        self.w.close()
