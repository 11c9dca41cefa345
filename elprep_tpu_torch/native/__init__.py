"""ctypes bindings for the native runtime components
(elprep_native.cpp: parallel BGZF codec + SAM tokenizer).

The shared library is built on demand with g++ (cached next to the
source); all entry points degrade to the pure-Python implementations
when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(__file__)
_SRCS = [os.path.join(_DIR, "elprep_native.cpp"),
         os.path.join(_DIR, "assembly_native.cpp"),
         os.path.join(_DIR, "clipping_native.cpp")]
_LIB = os.path.join(_DIR, "libelprep_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++20"]
    # build under a per-process name and rename into place, so processes
    # building at once never load a half-written library
    tmp = _LIB + f".tmp{os.getpid()}"
    # -fopenmp only enables the parallel stable sort (its use is
    # _OPENMP-guarded); retry without it on toolchains lacking OpenMP
    for extra in (["-fopenmp"], []):
        try:
            subprocess.run(
                base + extra + ["-o", tmp] + _SRCS + ["-lz", "-lpthread"],
                check=True, capture_output=True, timeout=240,
            )
            os.replace(tmp, _LIB)
            return True
        except Exception:
            continue
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or any(
            os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(_LIB)
            for s in _SRCS):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.bgzf_decompressed_size.restype = ctypes.c_longlong
    lib.bgzf_decompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.bgzf_decompress.restype = ctypes.c_int
    lib.bgzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int]
    lib.bgzf_compress_bound.restype = ctypes.c_size_t
    lib.bgzf_compress_bound.argtypes = [ctypes.c_size_t]
    lib.bgzf_compress.restype = ctypes.c_longlong
    lib.bgzf_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sam_count_lines.restype = ctypes.c_longlong
    lib.sam_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.sam_tokenize.restype = ctypes.c_longlong
    lib.sam_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.gvcf_format_blocks.restype = ctypes.c_longlong
    lib.gvcf_format_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong]
    lib.assembly_try.restype = ctypes.c_longlong
    lib.assembly_try.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,          # ref
        ctypes.c_void_p, ctypes.c_void_p,            # seq/qual concat (bytes or u8 array data)
        ctypes.c_void_p, ctypes.c_longlong,          # read offs, n_reads
        ctypes.c_int, ctypes.c_int, ctypes.c_int,    # k, min_q, last_attempt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # scores, bases, cap
        ctypes.c_void_p]                             # base offs
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def bgzf_decompress(data: bytes, n_threads: int = 0) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    size = lib.bgzf_decompressed_size(data, len(data))
    if size < 0:
        raise ValueError("invalid BGZF stream")
    out = np.empty(size, np.uint8)
    rc = lib.bgzf_decompress(data, len(data), out.ctypes.data, size, n_threads or _DEFAULT_THREADS[0])
    if rc != 0:
        raise ValueError(f"BGZF decompress failed (code {rc})")
    return out.tobytes()


def bgzf_compress(data, level: int = 6, n_threads: int = 0,
                  eof: bool = True, as_view: bool = False):
    """Parallel BGZF compress. ``data`` is any C-contiguous bytes-like
    (bytes, bytearray, memoryview) — non-bytes inputs avoid an upfront
    copy. With ``as_view`` the compressed output returns as a
    memoryview over the backing array (no bytes copy) for callers that
    only hand it to file.write."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(data, bytes):
        src_ptr, src_len = data, len(data)
    else:
        a = np.frombuffer(data, np.uint8)
        src_ptr, src_len = a.ctypes.data, len(a)
    cap = lib.bgzf_compress_bound(src_len)
    out = np.empty(cap, np.uint8)
    n = lib.bgzf_compress(src_ptr, src_len, out.ctypes.data, cap, level,
                          n_threads or _DEFAULT_THREADS[0], 1 if eof else 0)
    if n < 0:
        raise ValueError(f"BGZF compress failed (code {n})")
    return memoryview(out)[:n] if as_view else out[:n].tobytes()


def sam_tokenize(data: bytes, start: int) -> Optional[Tuple]:
    """Tokenize alignment lines. Returns (n, int_cols dict, ranges [7] of
    (start,end) int64 arrays) or None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    max_lines = lib.sam_count_lines(data, len(data), start)
    if max_lines == 0:
        z32 = np.zeros(0, np.int32)
        z64 = np.zeros((7, 0), np.int64)
        return 0, dict(flag=z32, pos=z32, mapq=z32, pnext=z32, tlen=z32), (z64, z64)
    flag = np.empty(max_lines, np.int32)
    pos = np.empty(max_lines, np.int32)
    mapq = np.empty(max_lines, np.int32)
    pnext = np.empty(max_lines, np.int32)
    tlen = np.empty(max_lines, np.int32)
    f_start = np.empty((7, max_lines), np.int64)
    f_end = np.empty((7, max_lines), np.int64)
    n = lib.sam_tokenize(
        data, len(data), start, max_lines,
        flag.ctypes.data, pos.ctypes.data, mapq.ctypes.data,
        pnext.ctypes.data, tlen.ctypes.data,
        f_start.ctypes.data, f_end.ctypes.data)
    if n < 0:
        errpos = -(n + 1)
        line_start = data.rfind(b"\n", 0, int(errpos)) + 1
        line_end = data.find(b"\n", int(errpos))
        if line_end < 0:
            line_end = len(data)
        raise ValueError(
            f"missing tabulator in SAM alignment line: {data[line_start:line_end]!r}")
    n = int(n)
    return n, dict(flag=flag[:n], pos=pos[:n], mapq=mapq[:n], pnext=pnext[:n],
                   tlen=tlen[:n]), (f_start[:, :n], f_end[:, :n])


def _bind_ragged(lib) -> None:
    for name in ("ranged_gather_u8", "ranged_scatter_u8", "ragged_to_padded",
                 "padded_to_ragged"):
        fn = getattr(lib, name, None)
        if fn is None:
            return
    lib.ranged_gather_u8.restype = None
    lib.ranged_gather_u8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                             ctypes.c_void_p, ctypes.c_int]
    lib.ranged_scatter_u8.restype = None
    lib.ranged_scatter_u8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                              ctypes.c_void_p, ctypes.c_int]
    lib.ragged_to_padded.restype = None
    lib.ragged_to_padded.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    lib.padded_to_ragged.restype = None
    lib.padded_to_ragged.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]


def ranged_gather_u8(data: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Fast ragged gather of byte ranges. Returns (flat, offsets) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ranged_gather_u8"):
        return None
    _bind_ragged(lib)
    lengths = (ends - starts).astype(np.int64)
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    out = np.empty(int(off[-1]), np.uint8)
    data = np.ascontiguousarray(data)
    starts = np.ascontiguousarray(starts.astype(np.int64))
    ends = np.ascontiguousarray(ends.astype(np.int64))
    lib.ranged_gather_u8(data.ctypes.data, starts.ctypes.data, ends.ctypes.data,
                         off.ctypes.data, len(lengths), out.ctypes.data, _DEFAULT_THREADS[0])
    return out, off


def ranged_scatter_u8(src: np.ndarray, src_offsets: np.ndarray,
                      dst_starts: np.ndarray, out: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None or not hasattr(lib, "ranged_scatter_u8"):
        return False
    _bind_ragged(lib)
    src = np.ascontiguousarray(src)
    src_offsets = np.ascontiguousarray(src_offsets.astype(np.int64))
    dst_starts = np.ascontiguousarray(dst_starts.astype(np.int64))
    lib.ranged_scatter_u8(src.ctypes.data, src_offsets.ctypes.data,
                          dst_starts.ctypes.data, len(dst_starts),
                          out.ctypes.data, _DEFAULT_THREADS[0])
    return True


def ragged_to_padded(data: np.ndarray, offsets: np.ndarray, width: int,
                     fill, dtype) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None or not hasattr(lib, "ragged_to_padded"):
        return None
    _bind_ragged(lib)
    n = len(offsets) - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets.astype(np.int64))
    # fused fill+copy when the fill value is byte-uniform (every current
    # caller's is): the row tails memset inside the same parallel pass,
    # so the destination's first-touch faults parallelize instead of
    # serializing through a Python-side np.full (~4 s per worker at 4M
    # reads in a bad fault-rate window)
    fill_bytes = np.full((1,), fill, dtype=dtype).tobytes()
    if (hasattr(lib, "ragged_to_padded_fillb")
            and len(set(fill_bytes)) == 1):
        if lib.ragged_to_padded_fillb.argtypes is None:
            lib.ragged_to_padded_fillb.restype = None
            lib.ragged_to_padded_fillb.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
        out = np.empty((n, width), dtype=dtype)
        lib.ragged_to_padded_fillb(
            data.ctypes.data, offsets.ctypes.data, n, width,
            data.dtype.itemsize, fill_bytes[0], out.ctypes.data,
            _DEFAULT_THREADS[0])
        return out
    out = np.full((n, width), fill, dtype=dtype)
    lib.ragged_to_padded(data.ctypes.data, offsets.ctypes.data, n, width,
                         data.dtype.itemsize, out.ctypes.data, _DEFAULT_THREADS[0])
    return out


def padded_to_ragged(padded: np.ndarray, offsets: np.ndarray,
                     out: np.ndarray) -> bool:
    """Inverse of ragged_to_padded: write row i's first len(i) elements of
    dense ``padded`` [n, width] into ``out`` (flat ragged buffer) at
    offsets[i]. Returns False when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "padded_to_ragged"):
        return False
    _bind_ragged(lib)
    n = len(offsets) - 1
    padded = np.ascontiguousarray(padded)
    if padded.dtype.itemsize != out.dtype.itemsize or not out.flags.c_contiguous:
        return False
    offsets = np.ascontiguousarray(offsets.astype(np.int64))
    lib.padded_to_ragged(padded.ctypes.data, offsets.ctypes.data, n,
                         padded.shape[1], padded.dtype.itemsize,
                         out.ctypes.data, _DEFAULT_THREADS[0])
    return True


# mode bits for clip_reads (mirror clipping_native.cpp)
CLIP_LOWQ_ENDS = 1
CLIP_SOFT_OR_REVERT = 2
CLIP_SOFTCLIP = 4
CLIP_ADAPTOR = 8
CLIP_ADAPTOR_IF_MAPPED = 16
CLIP_TO_REGION = 32


def clip_reads(flag, pos, pnext, tlen, mapq, cig_len: "Ragged-like tuple",
               qual_data, qual_offsets, rname_star, rnext_star, modes: int,
               lowq: int = 0, region_start: int = 0, region_end: int = 0):
    """Batched native clipping chain (oracle: filters/clipping.py, itself
    a port of the reference filters/utils.go:81-627).

    ``cig_len`` is (lens int32 flat, ops u8 flat, offsets int64).
    Returns dict with mutated flag/pos/mapq copies, new ragged cigars
    (n_ops, lens, ops at stride cig_off[i]+8*i), base_start/base_len
    windows — or None without the native lib. Raises ValueError when a
    reference coordinate maps to no read base (parity with the oracle).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "clip_reads_columnar"):
        return None
    if lib.clip_reads_columnar.argtypes is None:
        lib.clip_reads_columnar.restype = ctypes.c_longlong
        lib.clip_reads_columnar.argtypes = (
            [ctypes.c_longlong] + [ctypes.c_void_p] * 12
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [ctypes.c_int])
    lens_in, ops_in, cig_off = cig_len
    n = len(flag)
    flag = np.ascontiguousarray(flag, np.int32).copy()
    pos = np.ascontiguousarray(pos, np.int64).copy()
    pnext = np.ascontiguousarray(pnext, np.int64)
    tlen = np.ascontiguousarray(tlen, np.int64)
    mapq = np.ascontiguousarray(mapq, np.int32).copy()
    cig_off = np.ascontiguousarray(cig_off, np.int64)
    lens_in = np.ascontiguousarray(lens_in, np.int32)
    ops_in = np.ascontiguousarray(ops_in, np.uint8)
    qual_data = np.ascontiguousarray(qual_data, np.uint8)
    qual_offsets = np.ascontiguousarray(qual_offsets, np.int64)
    rname_star = np.ascontiguousarray(rname_star, np.uint8)
    rnext_star = np.ascontiguousarray(rnext_star, np.uint8)
    cap = int(cig_off[-1]) + 8 * n
    out_n_ops = np.zeros(n, np.int32)
    out_lens = np.zeros(cap, np.int32)
    out_ops = np.zeros(cap, np.uint8)
    out_bstart = np.zeros(n, np.int64)
    out_blen = np.zeros(n, np.int64)
    out_err = np.zeros(n, np.uint8)
    n_err = lib.clip_reads_columnar(
        n, flag.ctypes.data, pos.ctypes.data, pnext.ctypes.data,
        tlen.ctypes.data, mapq.ctypes.data, cig_off.ctypes.data,
        lens_in.ctypes.data, ops_in.ctypes.data, qual_data.ctypes.data,
        qual_offsets.ctypes.data, rname_star.ctypes.data,
        rnext_star.ctypes.data, modes, lowq, region_start, region_end,
        out_n_ops.ctypes.data, out_lens.ctypes.data, out_ops.ctypes.data,
        out_bstart.ctypes.data, out_blen.ctypes.data, out_err.ctypes.data,
        _DEFAULT_THREADS[0])
    if n_err:
        raise ValueError(
            "reference coordinate matches a non-existing base in read")
    return dict(flag=flag, pos=pos, mapq=mapq, n_ops=out_n_ops,
                lens=out_lens, ops=out_ops, cig_base=cig_off[:-1] + 8 * np.arange(n, dtype=np.int64),
                bstart=out_bstart, blen=out_blen)


def pack_nibbles(data: np.ndarray, offsets: np.ndarray, table: np.ndarray,
                 out_offsets: np.ndarray) -> "np.ndarray | None":
    """Pack ASCII base rows into BAM 4-bit nibbles (hi nibble first).
    Returns the packed flat buffer, or None without the native lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pack_nibbles_u8"):
        return None
    if lib.pack_nibbles_u8.argtypes is None:
        lib.pack_nibbles_u8.restype = None
        lib.pack_nibbles_u8.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    n = len(offsets) - 1
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    table = np.ascontiguousarray(table, np.uint8)
    out_offsets = np.ascontiguousarray(out_offsets, np.int64)
    out = np.zeros(int(out_offsets[-1]), np.uint8)
    lib.pack_nibbles_u8(data.ctypes.data, offsets.ctypes.data,
                        table.ctypes.data, out_offsets.ctypes.data, n,
                        out.ctypes.data, _DEFAULT_THREADS[0])
    return out


def sam_tags_to_bam(flat: np.ndarray, offsets: np.ndarray):
    """Batch-convert canonical tag text rows to BAM binary blocks.
    Returns (bin_flat, bin_offsets, fallback_row_indices) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sam_tags_to_bam"):
        return None
    if not hasattr(lib, "_tags_bound"):
        lib.sam_tags_to_bam.restype = ctypes.c_longlong
        lib.sam_tags_to_bam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.extract_z_tag.restype = None
        lib.extract_z_tag.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_ubyte, ctypes.c_ubyte, ctypes.c_void_p, ctypes.c_void_p]
        lib._tags_bound = True
    n = len(offsets) - 1
    flat = np.ascontiguousarray(flat)
    offsets = np.ascontiguousarray(offsets.astype(np.int64))
    cap = int(len(flat) * 4 + 64 * (n + 1) + 1024)
    out = np.empty(cap, np.uint8)
    out_offsets = np.empty(n + 1, np.int64)
    fallback = np.empty(n, np.int64)
    n_fallback = np.zeros(1, np.int64)
    rc = lib.sam_tags_to_bam(flat.ctypes.data, offsets.ctypes.data, n,
                             out.ctypes.data, cap, out_offsets.ctypes.data,
                             fallback.ctypes.data, n_fallback.ctypes.data, 0)
    if rc < 0:
        raise ValueError(f"invalid SAM tag field (code {rc})")
    return out[:rc], out_offsets, fallback[: int(n_fallback[0])]


def extract_z_tag(flat: np.ndarray, offsets: np.ndarray, tag: bytes):
    """Per-row :Z: tag value ranges (start==end==0 when absent), or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "extract_z_tag"):
        return None
    sam_tags_to_bam.__wrapped__ = None  # ensure binding side effects ran
    if not hasattr(lib, "_tags_bound"):
        sam_tags_to_bam(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    n = len(offsets) - 1
    flat = np.ascontiguousarray(flat)
    offsets = np.ascontiguousarray(offsets.astype(np.int64))
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    lib.extract_z_tag(flat.ctypes.data, offsets.ctypes.data, n,
                      tag[0], tag[1], starts.ctypes.data, ends.ctypes.data)
    return starts, ends


def sam_format_alignments(qname, flag, rname_id, pos, mapq,
                          cig_len_flat, cig_op_flat, cig_offsets,
                          rnext_id, pnext, tlen,
                          seq_flat, seq_offsets, qual_flat, qual_offsets,
                          tags_flat, tags_offsets, names):
    """Batch-format alignment lines to SAM text bytes, or None (caller
    falls back to the Python formatter, including on any malformed row)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sam_format_alignments"):
        return None
    if not hasattr(lib, "_fmt_bound"):
        lib.sam_format_alignments.restype = ctypes.c_longlong
        lib.sam_format_alignments.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_void_p] * 3
            + [ctypes.c_void_p] * 3
            + [ctypes.c_void_p] * 4
            + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int])
        lib._fmt_bound = True
    n = len(flag)
    if n == 0:
        return np.zeros(0, np.uint8)
    pool = names if names else [b""]
    name_lens = np.array([len(nm) for nm in pool], np.int64)
    names_offsets = np.zeros(len(pool) + 1, np.int64)
    np.cumsum(name_lens, out=names_offsets[1:])
    names_flat = np.frombuffer(b"".join(pool), np.uint8) if names_offsets[-1] else np.zeros(1, np.uint8)

    qname = np.ascontiguousarray(qname)
    qw = qname.dtype.itemsize
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    u8 = lambda a: np.ascontiguousarray(a, dtype=np.uint8)
    flag, rname_id, pos, mapq = i32(flag), i32(rname_id), i32(pos), i32(mapq)
    rnext_id, pnext, tlen = i32(rnext_id), i32(pnext), i32(tlen)
    cig_len_flat = i32(cig_len_flat)
    cig_op_flat, seq_flat, qual_flat, tags_flat = (
        u8(cig_op_flat), u8(seq_flat), u8(qual_flat), u8(tags_flat))
    cig_offsets, seq_offsets, qual_offsets, tags_offsets = (
        i64(cig_offsets), i64(seq_offsets), i64(qual_offsets), i64(tags_offsets))

    nops = cig_offsets[1:] - cig_offsets[:-1]
    bound = (
        qw + 24
        + name_lens[rname_id] + name_lens[rnext_id]
        + np.maximum(nops, 1) * 12 + 12 * 5
        + (seq_offsets[1:] - seq_offsets[:-1])
        + (qual_offsets[1:] - qual_offsets[:-1])
        + 2 * (tags_offsets[1:] - tags_offsets[:-1]) + 24
    ).astype(np.int64)
    slack_off = np.zeros(n + 1, np.int64)
    np.cumsum(bound, out=slack_off[1:])
    out = np.empty(int(slack_off[-1]), np.uint8)
    out_lens = np.empty(n, np.int64)
    rc = lib.sam_format_alignments(
        qname.ctypes.data, qw,
        flag.ctypes.data, rname_id.ctypes.data, pos.ctypes.data, mapq.ctypes.data,
        cig_len_flat.ctypes.data, cig_op_flat.ctypes.data, cig_offsets.ctypes.data,
        rnext_id.ctypes.data, pnext.ctypes.data, tlen.ctypes.data,
        seq_flat.ctypes.data, seq_offsets.ctypes.data,
        qual_flat.ctypes.data, qual_offsets.ctypes.data,
        tags_flat.ctypes.data, tags_offsets.ctypes.data,
        names_flat.ctypes.data, names_offsets.ctypes.data, len(pool),
        n, out.ctypes.data, slack_off.ctypes.data, out_lens.ctypes.data,
        _DEFAULT_THREADS[0])
    if rc != 0:
        return None
    final_off = np.zeros(n + 1, np.int64)
    np.cumsum(out_lens, out=final_off[1:])
    final = np.empty(int(final_off[-1]), np.uint8)
    _bind_ragged(lib)
    starts = slack_off[:-1]
    ends = starts + out_lens
    lib.ranged_gather_u8(out.ctypes.data, i64(starts).ctypes.data,
                         i64(ends).ctypes.data, final_off.ctypes.data,
                         n, final.ctypes.data, _DEFAULT_THREADS[0])
    return final


def gvcf_format_blocks(chrom: bytes, ref_base, pos, end, dp, gq, min_dp,
                       pls) -> "Optional[bytes]":
    """Format a columnar batch of GVCF reference-block records to VCF
    text bytes (identical to the per-record Python %-format). Returns
    None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(pos)
    if n == 0:
        return b""
    i64 = lambda a: np.ascontiguousarray(a, np.int64)
    pos, end, dp, gq, min_dp, pls = map(i64, (pos, end, dp, gq, min_dp, pls))
    rb = np.ascontiguousarray(ref_base, np.uint8)
    cap = n * (len(chrom) + 7 * 20 + 64) + 64
    out = np.empty(cap, np.uint8)
    written = lib.gvcf_format_blocks(
        chrom, len(chrom), rb.ctypes.data, pos.ctypes.data, end.ctypes.data,
        dp.ctypes.data, gq.ctypes.data, min_dp.ctypes.data, pls.ctypes.data,
        n, out.ctypes.data, cap)
    if written < 0:
        raise ValueError("gvcf_format_blocks: capacity underestimated")
    return out[:written].tobytes()


def refconf_informative(read_bases: bytes, read_quals: bytes, read_start: int,
                        ref: bytes, ref_index: int, padded_end: int,
                        read_length: int, max_indel: int,
                        base_mask: np.ndarray):
    """Per-read informative-indel bitset (bool [read_length]) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "refconf_informative"):
        return None
    if not hasattr(lib, "_refconf_bound"):
        lib.refconf_informative.restype = None
        lib.refconf_informative.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib._refconf_bound = True
    out = np.zeros(max(read_length, 1), np.uint8)
    mask = np.ascontiguousarray(base_mask, dtype=np.int64)
    lib.refconf_informative(
        read_bases, len(read_bases), read_quals, read_start, ref, ref_index,
        padded_end, read_length, max_indel, mask.ctypes.data, out.ctypes.data)
    return out[:read_length].astype(bool)


def activity_region(rows, cols: dict, low: int, high: int, ref: bytes,
                    params_i: dict, tables_d: dict):
    """Native isActive + hq-soft-clip means over [low, high)
    (oracle: hc/activity.py compute_activity). ``cols`` holds the
    ORIGINAL (pre-clip) block columns. Returns (is_active f64[n],
    hq_mean f64[n]) or None without the native lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "activity_region_columnar"):
        return None
    if lib.activity_region_columnar.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        D = ctypes.c_double
        lib.activity_region_columnar.restype = None
        lib.activity_region_columnar.argtypes = (
            [L, P] + [P] * 13 + [L, L] + [ctypes.c_char_p, L] + [L] * 3
            + [P, P, L, D, D, D, D, D, D, D, D, D] + [P, P])
    rows = np.ascontiguousarray(rows, np.int64)
    n_pos = high - low
    if n_pos <= 0:
        return (np.zeros(0, np.float64), np.zeros(0, np.float64))
    out_active = np.zeros(n_pos, np.float64)
    out_hq = np.zeros(n_pos, np.float64)
    lib.activity_region_columnar(
        len(rows), rows.ctypes.data,
        cols["flag"].ctypes.data, cols["pos"].ctypes.data,
        cols["pnext"].ctypes.data, cols["tlen"].ctypes.data,
        cols["cig_off"].ctypes.data, cols["cig_len"].ctypes.data,
        cols["cig_op"].ctypes.data, cols["seq_data"].ctypes.data,
        cols["seq_off"].ctypes.data, cols["qual_data"].ctypes.data,
        cols["qual_off"].ctypes.data, cols["rname_star"].ctypes.data,
        cols["rnext_star"].ctypes.data,
        low, high, ref, len(ref),
        params_i["min_base_qual"], params_i["hq_sc_threshold"],
        params_i["max_qual"],
        tables_d["qual2prob"].ctypes.data, tables_d["jac"].ctypes.data,
        len(tables_d["jac"]), tables_d["jac_step"], tables_d["jac_max_tol"],
        tables_d["log10_ploidy"], tables_d["log10_one_third"],
        params_i["p0"], params_i["p1"], params_i["p2"],
        params_i["acgt0_prior"], params_i["stdconf_min10"],
        out_active.ctypes.data, out_hq.ctypes.data)
    return out_active, out_hq


def bqsr_skip_sites(cand, pos, cig_base, n_ops, lens, ops, blen, sites,
                    skip, n_threads: int = 0) -> bool:
    """Native known-sites skip-mask fill (oracle: the per-read loop in
    filters/bqsr.py _prep_recal_native). ``skip`` is the row-major
    [m, L] bool array, written in place for the candidate rows. Returns
    False without the native lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bqsr_skip_sites"):
        return False
    if lib.bqsr_skip_sites.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.bqsr_skip_sites.restype = None
        lib.bqsr_skip_sites.argtypes = [L, P, P, P, P, P, P, P, P, L, P, L, L]
    cand = np.ascontiguousarray(cand, np.int64)
    if len(cand) == 0 or len(sites) == 0:
        return True
    pos = np.ascontiguousarray(pos, np.int64)
    cig_base = np.ascontiguousarray(cig_base, np.int64)
    n_ops = np.ascontiguousarray(n_ops, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    ops = np.ascontiguousarray(ops, np.uint8)
    blen = np.ascontiguousarray(blen, np.int64)
    sites = np.ascontiguousarray(sites, np.int64)
    n_sites = sites.shape[0] if sites.ndim == 2 else len(sites) // 2
    assert skip.dtype == np.bool_ and skip.flags.c_contiguous
    lib.bqsr_skip_sites(
        len(cand), cand.ctypes.data, pos.ctypes.data, cig_base.ctypes.data,
        n_ops.ctypes.data, lens.ctypes.data, ops.ctypes.data,
        blen.ctypes.data, sites.ctypes.data, n_sites,
        skip.ctypes.data, skip.shape[1],
        n_threads or _DEFAULT_THREADS[0])
    return True


def bqsr_histograms(qs_idx, cyc_idx, ctx_idx, err,
                    qs_size: int, cyc_size: int, ctx_size: int):
    """One-pass BQSR table histograms over flat covariate codes:
    returns six int32 arrays (qs_obs, qs_mism, cyc_obs, cyc_mism,
    ctx_obs, ctx_mism) or None without the native lib. The numpy
    where+bincount sequence in filters/bqsr.py accumulate_table_partials
    is the oracle (identical drop semantics for out-of-range codes)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bqsr_histograms"):
        return None
    if lib.bqsr_histograms.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.bqsr_histograms.restype = None
        lib.bqsr_histograms.argtypes = [P] * 4 + [L] * 4 + [P] * 6
    qs_idx = np.ascontiguousarray(qs_idx, np.int32).ravel()
    cyc_idx = np.ascontiguousarray(cyc_idx, np.int32).ravel()
    ctx_idx = np.ascontiguousarray(ctx_idx, np.int32).ravel()
    err = np.ascontiguousarray(err, np.int32).ravel()
    m = len(err)
    assert len(qs_idx) == m and len(cyc_idx) == m and len(ctx_idx) == m
    outs = [np.zeros(s, np.int32)
            for s in (qs_size, qs_size, cyc_size, cyc_size,
                      ctx_size, ctx_size)]
    lib.bqsr_histograms(
        qs_idx.ctypes.data, cyc_idx.ctypes.data, ctx_idx.ctypes.data,
        err.ctypes.data, m, qs_size, cyc_size, ctx_size,
        *(o.ctypes.data for o in outs))
    return outs


def bqsr_covariate_tables(sl: dict, ref_classes, max_cycle: int, n_rg: int,
                          n_threads: int = 0):
    """Fused covariate + histogram engine over one padded prep slice
    (keys per filters/bqsr.py _iter_prep_slices). Returns
    ``([qs_obs, qs_mism, cyc_obs, cyc_mism, ctx_obs, ctx_mism],
    max_abs_cycle)`` or None without the native lib. The jitted
    ops/bqsr_ops.recalibrate_codes + histogram sequence is the oracle
    (fuzzed in tests/test_bqsr.py)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bqsr_covariate_tables"):
        return None
    if lib.bqsr_covariate_tables.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.bqsr_covariate_tables.restype = L
        lib.bqsr_covariate_tables.argtypes = (
            [L] * 3 + [P] * 11 + [L] * 3 + [P] * 6 + [L])
    m, Lw, C = int(sl["m"]), sl["base"].shape[1], sl["op_class"].shape[1]
    base = np.ascontiguousarray(sl["base"], np.uint8)
    qual = np.ascontiguousarray(sl["qual"], np.uint8)
    skip = np.ascontiguousarray(sl["skip"], np.uint8)
    seq_len = np.ascontiguousarray(sl["seq_len"], np.int32)
    flag = np.ascontiguousarray(sl["flag"], np.int32)
    pos = np.ascontiguousarray(sl["pos"], np.int32)
    rg = np.ascontiguousarray(sl["rg"], np.int32)
    refoff = np.ascontiguousarray(sl["refoff"], np.int64)
    op_class = np.ascontiguousarray(sl["op_class"], np.int8)
    op_len = np.ascontiguousarray(sl["op_len"], np.int32)
    classes = np.ascontiguousarray(ref_classes, np.uint8)
    ncyc = 2 * max_cycle + 1
    qs_size = n_rg * 94
    outs = [np.zeros(s, np.int32)
            for s in (qs_size, qs_size, qs_size * ncyc, qs_size * ncyc,
                      qs_size * 16, qs_size * 16)]
    mac = lib.bqsr_covariate_tables(
        m, Lw, C, base.ctypes.data, qual.ctypes.data, skip.ctypes.data,
        seq_len.ctypes.data, flag.ctypes.data, pos.ctypes.data,
        rg.ctypes.data, refoff.ctypes.data, op_class.ctypes.data,
        op_len.ctypes.data, classes.ctypes.data, len(classes),
        max_cycle, n_rg, *(o.ctypes.data for o in outs),
        n_threads or _DEFAULT_THREADS[0])
    return outs, int(mac)


def gvcf_band_blocks(gq, dp, pls, j: int, bands):
    """Complete GVCF band blocks of one reference run (the numpy
    searchsorted/reduceat/median sequence in hc/refconf.py
    _merge_run_impl is the oracle). Returns (starts, counts, med,
    min_dp, gq_b, min_pls[nb,3], open_start) or None without the
    native lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gvcf_band_blocks"):
        return None
    if lib.gvcf_band_blocks.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.gvcf_band_blocks.restype = L
        lib.gvcf_band_blocks.argtypes = [P] * 3 + [L] * 2 + [P] + [L] + \
            [P] * 7 + [L]
    gq = np.ascontiguousarray(gq, np.int32)
    dp = np.ascontiguousarray(dp, np.int32)
    pls = np.ascontiguousarray(pls, np.int32)
    bands_a = np.ascontiguousarray(bands, np.int64)
    m = len(gq)
    cap = max(1, m - j)
    # np.empty, not zeros: the kernel writes only the first nb entries
    # and nb << cap on real data, so the six cap-sized memsets are pure
    # waste (few ms warm, tens of ms inside host fault-throttle windows
    # where memset faults fresh pages at 40-100 MB/s)
    starts = np.empty(cap, np.int64)
    counts = np.empty(cap, np.int64)
    med = np.empty(cap, np.int64)
    min_dp = np.empty(cap, np.int64)
    gq_b = np.empty(cap, np.int64)
    min_pls = np.empty((cap, 3), np.int64)
    open_start = np.zeros(1, np.int64)
    nb = lib.gvcf_band_blocks(
        gq.ctypes.data, dp.ctypes.data, pls.ctypes.data, m, j,
        bands_a.ctypes.data, len(bands_a), starts.ctypes.data,
        counts.ctypes.data, med.ctypes.data, min_dp.ctypes.data,
        gq_b.ctypes.data, min_pls.ctypes.data, open_start.ctypes.data, cap)
    if nb < 0:
        return None
    return (starts[:nb], counts[:nb], med[:nb], min_dp[:nb], gq_b[:nb],
            min_pls[:nb], int(open_start[0]))


def bqsr_apply_quals(base, qual, seq_len, flag, rg, rg_present, cond_prior,
                     d_cyc, d_ctx, quant_lut, sqq_lut, max_cycle: int,
                     n_threads: int = 0):
    """Native ApplyBQSR over padded [m, L] columns. Returns
    (newq uint8 [m, L], max_abs_cycle) or None without the native lib.
    ops/bqsr_ops.apply_bqsr (jit) is the oracle (fuzzed in
    tests/test_bqsr.py)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bqsr_apply_quals"):
        return None
    if lib.bqsr_apply_quals.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.bqsr_apply_quals.restype = L
        lib.bqsr_apply_quals.argtypes = [L] * 2 + [P] * 11 + [L] * 2 + [P, L]
    base = np.ascontiguousarray(base, np.uint8)
    qual = np.ascontiguousarray(qual, np.uint8)
    seq_len = np.ascontiguousarray(seq_len, np.int32)
    flag = np.ascontiguousarray(flag, np.int32)
    rg = np.ascontiguousarray(rg, np.int32)
    rg_present = np.ascontiguousarray(rg_present, np.uint8)
    cond_prior = np.ascontiguousarray(cond_prior, np.int32)
    d_cyc = np.ascontiguousarray(d_cyc, np.int32)
    d_ctx = np.ascontiguousarray(d_ctx, np.int32)
    quant_lut = np.ascontiguousarray(quant_lut, np.uint8)
    sqq_lut = np.ascontiguousarray(sqq_lut, np.uint8)
    m, Lw = base.shape
    n_rg = cond_prior.shape[0]
    out = np.zeros((m, Lw), np.uint8)
    mac = lib.bqsr_apply_quals(
        m, Lw, base.ctypes.data, qual.ctypes.data, seq_len.ctypes.data,
        flag.ctypes.data, rg.ctypes.data, rg_present.ctypes.data,
        cond_prior.ctypes.data, d_cyc.ctypes.data, d_ctx.ctypes.data,
        quant_lut.ctypes.data, sqq_lut.ctypes.data, max_cycle, n_rg,
        out.ctypes.data, n_threads or _DEFAULT_THREADS[0])
    return out, int(mac)


def bqsr_apply_quals_ragged(base_data, qual_data, offsets, flag, rg,
                            rg_present, cond_prior, d_cyc, d_ctx, quant_lut,
                            sqq_lut, max_cycle: int, n_threads: int = 0):
    """Native ApplyBQSR over the ragged seq/qual buffers IN PLACE:
    recalibrated quals are written straight into ``qual_data``, so no
    padded [m, L] base/qual/newq intermediates exist (each is ~150 MB
    at 1M reads, and fresh first-touch faults on this host class run
    10-100x slower than warm pages). Requires seq and qual to share
    ``offsets``. Returns max_abs_cycle or None without the native lib.
    The padded bqsr_apply_quals (itself fuzzed against the jit oracle)
    is this twin's oracle in tests/test_bqsr.py."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "bqsr_apply_quals_ragged"):
        return None
    if lib.bqsr_apply_quals_ragged.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.bqsr_apply_quals_ragged.restype = L
        lib.bqsr_apply_quals_ragged.argtypes = [L] + [P] * 11 + [L] * 2 + [P, L]
    if (base_data.dtype != np.uint8 or qual_data.dtype != np.uint8
            or not base_data.flags.c_contiguous
            or not qual_data.flags.c_contiguous):
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    flag = np.ascontiguousarray(flag, np.int32)
    rg = np.ascontiguousarray(rg, np.int32)
    rg_present = np.ascontiguousarray(rg_present, np.uint8)
    cond_prior = np.ascontiguousarray(cond_prior, np.int32)
    d_cyc = np.ascontiguousarray(d_cyc, np.int32)
    d_ctx = np.ascontiguousarray(d_ctx, np.int32)
    quant_lut = np.ascontiguousarray(quant_lut, np.uint8)
    sqq_lut = np.ascontiguousarray(sqq_lut, np.uint8)
    m = len(offsets) - 1
    n_rg = cond_prior.shape[0]
    mac = lib.bqsr_apply_quals_ragged(
        m, base_data.ctypes.data, qual_data.ctypes.data, offsets.ctypes.data,
        flag.ctypes.data, rg.ctypes.data, rg_present.ctypes.data,
        cond_prior.ctypes.data, d_cyc.ctypes.data, d_ctx.ctypes.data,
        quant_lut.ctypes.data, sqq_lut.ctypes.data, max_cycle, n_rg,
        qual_data.ctypes.data, n_threads or _DEFAULT_THREADS[0])
    return int(mac)


def dedup_score_upos(qual: "np.ndarray", qual_off, cig_len, cig_op, cig_off,
                     pos, flag, n_threads: int = 0):
    """One-pass ragged (unclipped_position, phred_score) for duplicate
    marking — the jit oracles in ops/readstats.py are the fuzz-pinned
    contract (tests/test_sort_dedup.py); no padded [n,L]/[n,C]
    intermediates. Returns (upos int32, score int32) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "dedup_score_upos"):
        return None
    if lib.dedup_score_upos.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.dedup_score_upos.restype = None
        lib.dedup_score_upos.argtypes = [P] * 7 + [L, P, P, ctypes.c_int]
    qual = np.ascontiguousarray(qual, np.uint8)
    qual_off = np.ascontiguousarray(qual_off, np.int64)
    cig_len = np.ascontiguousarray(cig_len, np.int32)
    cig_op = np.ascontiguousarray(cig_op, np.uint8)
    cig_off = np.ascontiguousarray(cig_off, np.int64)
    pos = np.ascontiguousarray(pos, np.int32)
    flag = np.ascontiguousarray(flag, np.int32)
    n = len(pos)
    upos = np.empty(n, np.int32)
    score = np.empty(n, np.int32)
    lib.dedup_score_upos(
        qual.ctypes.data, qual_off.ctypes.data, cig_len.ctypes.data,
        cig_op.ctypes.data, cig_off.ctypes.data, pos.ctypes.data,
        flag.ctypes.data, n, upos.ctypes.data, score.ctypes.data,
        n_threads or _DEFAULT_THREADS[0])
    return upos, score


def stable_sort_idx(w0, w1=None, w2=None, w3=None):
    """Stable index sort by up to four packed uint64 key words. Returns
    int32 perm or None without the native lib — equal to np.lexsort
    over the same lexicographic key order."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "stable_sort_idx"):
        return None
    if lib.stable_sort_idx.argtypes is None:
        lib.stable_sort_idx.restype = None
        lib.stable_sort_idx.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p]
    w0 = np.ascontiguousarray(w0, np.uint64)
    n = len(w0)
    out = np.empty(n, np.int32)

    def ptr(a, dt):
        if a is None:
            return None
        a = np.ascontiguousarray(a, dt)
        assert len(a) == n
        ptr.keep.append(a)
        return a.ctypes.data
    ptr.keep = []
    lib.stable_sort_idx(w0.ctypes.data, ptr(w1, np.uint64),
                        ptr(w2, np.uint64), ptr(w3, np.uint64), n,
                        out.ctypes.data)
    return out


def parallel_copy(dst, src) -> bool:
    """Threaded flat copy of ``src`` (contiguous ndarray) into ``dst``
    (contiguous ndarray view of the same shape/dtype). Returns False
    without the native lib (caller falls back to numpy assignment).
    First-touch faults on fresh destination pages parallelize across
    the copy threads — the motivating case is the one big shm segment
    per run (hc/parallel._arrays_to_shm)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "parallel_memcpy"):
        return False
    if lib.parallel_memcpy.argtypes is None:
        lib.parallel_memcpy.restype = None
        lib.parallel_memcpy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int]
    if (not dst.flags["C_CONTIGUOUS"] or not src.flags["C_CONTIGUOUS"]
            or dst.nbytes != src.nbytes):
        return False
    lib.parallel_memcpy(dst.ctypes.data, src.ctypes.data, dst.nbytes, 0)
    return True


def qname_ranks_fixed(arr):
    """Dense lexicographic ranks of a C-contiguous numpy 'S' array
    (parallel native sort). Returns int32 ranks or None without the
    lib — equal to np.unique(arr, return_inverse=True)[1]
    (ops/sortkeys.qname_ranks's numpy path is the fuzzed oracle)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "qname_ranks_fixed"):
        return None
    if lib.qname_ranks_fixed.argtypes is None:
        lib.qname_ranks_fixed.restype = None
        lib.qname_ranks_fixed.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    out = np.empty(n, np.int32)
    if n:
        lib.qname_ranks_fixed(arr.ctypes.data, n, arr.dtype.itemsize,
                              out.ctypes.data)
    return out


def pairhmm_repeat_lengths(bases: bytes):
    """Per-base tandem-repeat lengths (uint8, 21 sentinel on the last
    base) or None without the native lib. ops/pairhmm.py
    _repeat_lengths_for_read_py is the oracle."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pairhmm_repeat_lengths"):
        return None
    if lib.pairhmm_repeat_lengths.argtypes is None:
        lib.pairhmm_repeat_lengths.restype = None
        lib.pairhmm_repeat_lengths.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p]
    n = len(bases)
    out = np.empty(n, np.uint8)
    lib.pairhmm_repeat_lengths(bases, n, out.ctypes.data)
    return out


def good_cigar_mask(cigar_len, cigar_op):
    """Batched isGoodCigar (haploutils.go:36-113) over ragged cigars.
    Returns a bool[n] mask, or None without the native lib. The Python
    loop in filters/hcprep.py is the oracle."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "good_cigar_mask"):
        return None
    if lib.good_cigar_mask.argtypes is None:
        lib.good_cigar_mask.restype = None
        lib.good_cigar_mask.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    off = np.ascontiguousarray(cigar_len.offsets, np.int64)
    lens = np.ascontiguousarray(cigar_len.data, np.int32)
    ops = np.ascontiguousarray(cigar_op.data, np.uint8)
    n = len(off) - 1
    out = np.zeros(n, np.uint8)
    lib.good_cigar_mask(n, off.ctypes.data, lens.ctypes.data, ops.ctypes.data,
                        out.ctypes.data)
    return out.astype(bool)


# the rc_finalize-based C exports (refconf_region_columnar,
# refconf_regions_batch, finalize_region_reads) share this exact column
# order — ONE list kept in sync with clipping_native.cpp's signatures
_RC_COLS = ("flag", "pos", "pnext", "tlen", "mapq", "qrank", "bad_mate",
            "n_ops", "cig_base", "lens", "ops", "seq_data", "seq_off",
            "qual_data", "qual_off", "bstart", "blen")


def _rc_col_ptrs(cols: dict):
    return [cols[k].ctypes.data for k in _RC_COLS]


def refconf_region(rows, cols: dict, padded_start: int, padded_end: int,
                   low: int, high: int, ref: bytes, params_i: dict,
                   tables_d: dict):
    """Whole no-variation-region GVCF reference model in one native call
    (oracle: hc/refconf.py reference_model_for_no_variation). ``cols``
    holds the per-block columnar arrays (see hc/readblock.preclip_block);
    ``params_i`` the integer params; ``tables_d`` the float tables.
    Returns (ad_ref, ad_nonref, pls[n,3], gq) int64 arrays, or None when
    the native lib is unavailable or the oracle path would raise."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "refconf_region_columnar"):
        return None
    if lib.refconf_region_columnar.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        D = ctypes.c_double
        lib.refconf_region_columnar.restype = L
        lib.refconf_region_columnar.argtypes = (
            [L, P] + [P] * 17 + [L, L, L, L] + [ctypes.c_char_p, L]
            + [L] * 5 + [P, P, L, D, D, D, D, P, P, P] + [P] * 4)
    rows = np.ascontiguousarray(rows, np.int64)
    n_pos = high - low
    ad_ref = np.zeros(n_pos, np.int64)
    ad_nonref = np.zeros(n_pos, np.int64)
    pls = np.zeros(n_pos * 3, np.int64)
    gq = np.zeros(n_pos, np.int64)
    rc = lib.refconf_region_columnar(
        len(rows), rows.ctypes.data,
        *_rc_col_ptrs(cols),
        padded_start, padded_end, low, high, ref, len(ref),
        params_i["max_indel"], params_i["min_read_len"],
        params_i["min_mapq"], params_i["max_informative"],
        params_i["max_qual"],
        tables_d["qual2prob"].ctypes.data, tables_d["jac"].ctypes.data,
        len(tables_d["jac"]), tables_d["jac_step"], tables_d["jac_max_tol"],
        tables_d["log10_ploidy"], tables_d["log10_one_third"],
        tables_d["indel_gq"].ctypes.data, tables_d["indel_pls"].ctypes.data,
        tables_d["base_mask"].ctypes.data,
        ad_ref.ctypes.data, ad_nonref.ctypes.data, pls.ctypes.data,
        gq.ctypes.data)
    if rc != 0:
        return None
    return ad_ref, ad_nonref, pls.reshape(n_pos, 3), gq


def finalize_region_seq_quals(rows, cols: dict, padded_start: int,
                              padded_end: int):
    """Columnar finalize for an ACTIVE region's candidate rows: region
    clip + coordinate sort + overlapping-mate reconciliation in one
    native call, returning the assembly engine's input — concatenated
    (seq, qual) buffers + offsets over the kept reads in sorted order
    (oracle: finalize_assembly_region + the [(r.seq, r.qual)]
    comprehension in hc/driver.prepare_region). Returns
    (offs int64 [n+1], seq_concat u8, qual_concat u8) or None when the
    native lib is unavailable or the oracle path would raise."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "finalize_region_reads"):
        return None
    if lib.finalize_region_reads.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        lib.finalize_region_reads.restype = L
        lib.finalize_region_reads.argtypes = (
            [L, P] + [P] * 17 + [L, L] + [P, P, L, P])
    rows = np.ascontiguousarray(rows, np.int64)
    n = len(rows)
    if n == 0:
        return np.zeros(1, np.int64), np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    cap = int(np.asarray(cols["blen"])[rows].sum())
    out_seq = np.empty(cap, np.uint8)
    out_qual = np.empty(cap, np.uint8)
    out_offs = np.zeros(n + 1, np.int64)
    n_kept = lib.finalize_region_reads(
        n, rows.ctypes.data,
        *_rc_col_ptrs(cols),
        padded_start, padded_end,
        out_seq.ctypes.data, out_qual.ctypes.data, cap, out_offs.ctypes.data)
    if n_kept < 0:
        return None
    return out_offs[: n_kept + 1], out_seq, out_qual


def refconf_regions_batch(regions, out_off, positions, ends,
                          max_ref_len: int, cols: dict, ref: bytes,
                          params_i: dict, tables_d: dict):
    """Batched :func:`refconf_region` over many no-variation regions of
    one worker block: row selection (positions/ends binary search) and
    the per-region loop run natively. ``regions`` is an int64 [n, 4]
    array of (padded_start, padded_end, low, high); ``out_off`` the
    int64 [n] prefix offsets into the concatenated outputs. Returns
    (rc[n], ad_ref, ad_nonref, pls[total,3], gq) or None without the
    native lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "refconf_regions_batch"):
        return None
    if lib.refconf_regions_batch.argtypes is None:
        L = ctypes.c_longlong
        P = ctypes.c_void_p
        D = ctypes.c_double
        lib.refconf_regions_batch.restype = None
        lib.refconf_regions_batch.argtypes = (
            [L] + [P] * 5 + [P, P, L, L] + [P] * 17
            + [ctypes.c_char_p, L] + [L] * 5
            + [P, P, L, D, D, D, D, P, P, P] + [P] * 5)
    regions = np.ascontiguousarray(regions, np.int64)
    out_off = np.ascontiguousarray(out_off, np.int64)
    positions = np.ascontiguousarray(positions, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    n = len(regions)
    total = int(out_off[-1]) if n else 0
    rps = np.ascontiguousarray(regions[:, 0])
    rpe = np.ascontiguousarray(regions[:, 1])
    rlo = np.ascontiguousarray(regions[:, 2])
    rhi = np.ascontiguousarray(regions[:, 3])
    ad_ref = np.zeros(total, np.int64)
    ad_nonref = np.zeros(total, np.int64)
    pls = np.zeros(total * 3, np.int64)
    gq = np.zeros(total, np.int64)
    rc = np.zeros(n, np.int64)
    lib.refconf_regions_batch(
        n, rps.ctypes.data, rpe.ctypes.data, rlo.ctypes.data,
        rhi.ctypes.data, out_off.ctypes.data,
        positions.ctypes.data, ends.ctypes.data, len(positions),
        max_ref_len,
        *_rc_col_ptrs(cols),
        ref, len(ref),
        params_i["max_indel"], params_i["min_read_len"],
        params_i["min_mapq"], params_i["max_informative"],
        params_i["max_qual"],
        tables_d["qual2prob"].ctypes.data, tables_d["jac"].ctypes.data,
        len(tables_d["jac"]), tables_d["jac_step"], tables_d["jac_max_tol"],
        tables_d["log10_ploidy"], tables_d["log10_one_third"],
        tables_d["indel_gq"].ctypes.data, tables_d["indel_pls"].ctypes.data,
        tables_d["base_mask"].ctypes.data,
        ad_ref.ctypes.data, ad_nonref.ctypes.data, pls.ctypes.data,
        gq.ctypes.data, rc.ctypes.data)
    return rc, ad_ref, ad_nonref, pls.reshape(total, 3), gq


def x86_log10(x: float):
    """Java-parity x87 log10 (reference: pedantic.go:29-52), or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "x86_log10"):
        return None
    if not hasattr(lib, "_log10_bound"):
        lib.x86_log10.restype = ctypes.c_double
        lib.x86_log10.argtypes = [ctypes.c_double]
        lib._log10_bound = True
    return float(lib.x86_log10(x))


_DEFAULT_THREADS = [0]  # 0 = hardware concurrency


def set_default_threads(n: int) -> None:
    """Cap native thread pools (--nr-of-threads; the reference maps the
    flag to GOMAXPROCS, cmd/filter.go:906-909)."""
    _DEFAULT_THREADS[0] = max(int(n), 0)


def default_threads() -> int:
    return _DEFAULT_THREADS[0]


def assembly_try(ref: bytes, reads, kmer_size: int, min_base_qual: int,
                 last_attempt: bool):
    """One native de Bruijn assembly attempt (assembly_native.cpp; the
    Python hc.assembly.process_kmer_size is the oracle). ``reads`` is a
    list of (seq bytes, qual bytes) OR a columnar ``(seq_flat, qual_flat,
    offsets)`` triple (the finalize_region_seq_quals output shape — no
    per-read bytes objects or re-concatenation). Returns a list of
    (score, bases) candidate haplotypes, or False when the attempt
    fails, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(reads, tuple):
        seq_flat, qual_flat, offs = reads
        seq_flat = np.ascontiguousarray(seq_flat, np.uint8)
        qual_flat = np.ascontiguousarray(qual_flat, np.uint8)
        offs = np.ascontiguousarray(offs, np.int64)
        n = len(offs) - 1
        seq_concat = seq_flat.ctypes.data
        qual_concat = qual_flat.ctypes.data
    else:
        n = len(reads)
        offs = np.empty(n + 1, np.int64)
        offs[0] = 0
        for i, (s, _) in enumerate(reads):
            offs[i + 1] = offs[i] + len(s)
        seq_concat = b"".join(s for s, _ in reads)
        qual_concat = b"".join(q for _, q in reads)
    # reusable per-process output buffers (calls are serial per process)
    bufs = _ASSEMBLY_BUFS
    if bufs is None:
        bufs = globals()["_ASSEMBLY_BUFS"] = [
            np.empty(128, np.float64), np.empty(129, np.int64),
            np.empty(1 << 20, np.uint8)]
    scores, base_offs, bases = bufs
    while True:
        rc = lib.assembly_try(
            ref, len(ref), seq_concat, qual_concat,
            offs.ctypes.data, n, kmer_size, min_base_qual,
            1 if last_attempt else 0,
            scores.ctypes.data, bases.ctypes.data, len(bases),
            base_offs.ctypes.data)
        if rc == -2:
            bases = bufs[2] = np.empty(len(bases) * 4, np.uint8)
            continue
        break
    if rc == -1:
        return False
    out = []
    for i in range(int(rc)):
        b = bases[base_offs[i] : base_offs[i + 1]].tobytes()
        out.append((float(scores[i]), b))
    return out


_ASSEMBLY_BUFS = None


_malloc_tuned = False


def tune_malloc() -> None:
    """Keep large freed allocations in the process arena.

    glibc serves big numpy buffers via mmap and returns them to the OS
    on free; every reallocation then pays first-touch page faults, which
    on virtualized hosts can run at ~100 MB/s — measured 50x slowdowns
    on transient 400 MB arrays in this pipeline. Disabling mmap'd
    allocations (M_MMAP_MAX=0) and heap trimming (M_TRIM_THRESHOLD=-1)
    makes the arena fault once and stay resident — the right trade for a
    batch in-memory pipeline (the reference is likewise an in-memory
    design). No-op if glibc mallopt is unavailable."""
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-1, -1)  # M_TRIM_THRESHOLD: never trim
        libc.mallopt(-4, 0)   # M_MMAP_MAX: no mmap'd allocations
    except Exception:
        pass
    _install_np_allocator()


_NPALLOC_SRC = os.path.join(_DIR, "npalloc.c")
_NPALLOC_LIB = os.path.join(_DIR, "_npalloc.so")


def _install_np_allocator() -> bool:
    """Route numpy buffers >= 1 MiB through MAP_SHARED anonymous mmap
    (npalloc.c, PyDataMem_SetHandler). Measured on this VM class:
    private-anon first touch faults at ~70 MB/s (a fresh 512 MB np.full
    costs ~7 s) while MAP_SHARED pages fault at ~1.2 GB/s — a 15x
    first-allocation speedup for the big padded columns. Gated by
    ELPREP_TPU_NO_NPALLOC; safe no-op when the toolchain is missing."""
    if os.environ.get("ELPREP_TPU_NO_NPALLOC"):
        return False
    try:
        if (not os.path.exists(_NPALLOC_LIB)
                or os.path.getmtime(_NPALLOC_SRC)
                > os.path.getmtime(_NPALLOC_LIB)):
            import sysconfig

            tmp = _NPALLOC_LIB + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _NPALLOC_SRC,
                 "-I", sysconfig.get_paths()["include"],
                 "-I", np.get_include()],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _NPALLOC_LIB)
        import importlib.util

        spec = importlib.util.spec_from_file_location("_npalloc", _NPALLOC_LIB)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.install()
        return True
    except Exception:
        return False
