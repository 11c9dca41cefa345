"""Parallel BGZF block codec.

The reference implements BGZF as a 3-stage pargo pipeline: serial block
framing from the gzip "BC" extra subfield, parallel flate decompress with
CRC32 checks, ordered emit (reference: utils/bgzf/bgzf-files.go:95-265;
writer mirror :324-431). Here framing is a serial scan over the in-memory
buffer and the per-block inflate/deflate fans out over a thread pool
(zlib releases the GIL), with order restored by list position — the same
structure without channels.

Maximum uncompressed payload per block is 65536 bytes
(bgzf-files.go:51); the closing EOF marker is the fixed 28-byte empty
block (bgzf-files.go:53-63).
"""

from __future__ import annotations

import struct
import zlib
from typing import List

MAX_BLOCK_SIZE = 65536

# Empty-payload BGZF block marking EOF (reference: bgzf-files.go:53-63).
BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00,
    0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00,
    0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00,
])

def _pool():
    from ..hostpool import shared_pool

    return shared_pool()


def _frame_blocks(data: bytes) -> List[range]:
    """Serial stage: find (start, end) of every gzip member using the BC
    extra subfield (reference: readBgzfBlock, bgzf-files.go:95-160)."""
    spans: List[range] = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError("did not find gzip magic in BGZF block header")
        flg = data[pos + 3]
        if not flg & 4:
            raise ValueError("BGZF block without FEXTRA flag")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # scan the extra subfields for 'BC'
        xpos = pos + 12
        xend = xpos + xlen
        bsize = None
        while xpos < xend:
            si1, si2, slen = data[xpos], data[xpos + 1], struct.unpack_from("<H", data, xpos + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
            xpos += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC extra subfield")
        if bsize < 12 + xlen + 8 or pos + bsize > n:
            raise ValueError("corrupt BGZF block: BSIZE smaller than its own framing")
        spans.append(range(pos, pos + bsize))
        pos += bsize
    return spans


def _inflate_block(data: bytes, span: range) -> bytes:
    flg = data[span.start + 3]
    xlen = struct.unpack_from("<H", data, span.start + 10)[0]
    payload_start = span.start + 12 + xlen
    if flg & ~4:
        raise ValueError("unsupported gzip FLG bits in BGZF block")
    crc, isize = struct.unpack_from("<II", data, span.stop - 8)
    raw = zlib.decompress(data[payload_start : span.stop - 8], wbits=-15)
    if len(raw) != isize:
        raise ValueError("BGZF block size mismatch")
    if zlib.crc32(raw) != crc:
        raise ValueError("BGZF block CRC32 mismatch")
    return raw


def decompress(data: bytes) -> bytes:
    """Decompress a whole BGZF byte buffer (all blocks, parallel).
    Uses the native C++ codec when available (elprep_tpu_torch.native)."""
    if not data:
        return b""
    from .. import native

    if native.available():
        out = native.bgzf_decompress(data)
        if out is not None:
            return out
    spans = _frame_blocks(data)
    if len(spans) == 1:
        return _inflate_block(data, spans[0])
    chunks = list(_pool().map(lambda s: _inflate_block(data, s), spans))
    return b"".join(chunks)


def _deflate_block(chunk: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(chunk) + co.flush()
    bsize = len(payload) + 12 + 6 + 8
    if bsize > MAX_BLOCK_SIZE:
        # incompressible payload: halve the chunk so BSIZE fits in uint16
        half = len(chunk) // 2
        return _deflate_block(chunk[:half], level) + _deflate_block(chunk[half:], level)
    header = struct.pack(
        "<2sBBIBBH2sHH",
        b"\x1f\x8b", 8, 4, 0, 0, 0xFF, 6, b"BC", 2, bsize - 1,
    )
    trailer = struct.pack("<II", zlib.crc32(chunk), len(chunk))
    return header + payload + trailer


def compress(data, level: int = 6, eof: bool = True, as_view: bool = False):
    """Compress a byte buffer into BGZF blocks (64KB chop, parallel) and
    append the EOF marker (reference: bgzf-files.go:324-431).
    Uses the native C++ codec when available. ``data`` may be any
    bytes-like; ``as_view`` returns a writable-to-file memoryview
    instead of bytes (saves a multi-MB copy per streaming flush)."""
    from .. import native

    if native.available():
        out = native.bgzf_compress(data, level=level, eof=eof,
                                   as_view=as_view)
        if out is not None:
            return out
    data = bytes(data)
    chunks = [data[i : i + MAX_BLOCK_SIZE] for i in range(0, len(data), MAX_BLOCK_SIZE)]
    if len(chunks) <= 1:
        blocks = [_deflate_block(c, level) for c in chunks]
    else:
        blocks = list(_pool().map(lambda c: _deflate_block(c, level), chunks))
    if eof:
        blocks.append(BGZF_EOF)
    return b"".join(blocks)


def is_bgzf(data: bytes) -> bool:
    return data[:2] == b"\x1f\x8b" and len(data) >= 12 and (data[3] & 4) != 0


# ---------------------------------------------------------------------------
# Streaming (bounded-memory) reader / writer
# (reference: the pipelined reader/writer of utils/bgzf/bgzf-files.go
# presents io.Reader/io.Writer over the parallel block codec; here the
# same bounded-memory contract is a chunk iterator + a buffered writer)
# ---------------------------------------------------------------------------


def _complete_prefix(data: bytes) -> int:
    """Byte length of the longest prefix of ``data`` consisting of whole
    BGZF blocks (framing walk only, no decompression)."""
    pos = 0
    n = len(data)
    while True:
        if pos + 18 > n:
            return pos
        if data[pos : pos + 2] != b"\x1f\x8b" or not data[pos + 3] & 4:
            raise ValueError("did not find gzip magic in BGZF block header")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        if pos + 12 + xlen > n:
            return pos
        xpos, xend, bsize = pos + 12, pos + 12 + xlen, None
        while xpos + 4 <= xend:
            si1, si2, slen = data[xpos], data[xpos + 1], struct.unpack_from("<H", data, xpos + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
            xpos += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC extra subfield")
        if bsize < 12 + xlen + 8:
            raise ValueError("corrupt BGZF block: BSIZE smaller than its own framing")
        if pos + bsize > n:
            return pos
        pos += bsize


def iter_bgzf_chunks(f, head: bytes = b"", slab_bytes: int = 16 << 20):
    """Yield uncompressed chunks from a BGZF stream in bounded memory:
    compressed slabs are framed to whole blocks and decompressed with
    the parallel codec; partial trailing blocks carry into the next
    slab. ``head`` holds bytes already consumed from ``f`` (sniffing)."""
    carry = bytes(head)
    while True:
        slab = f.read(slab_bytes)
        if not slab:
            if carry:
                # must end on a block boundary
                if _complete_prefix(carry) != len(carry):
                    raise ValueError("truncated BGZF stream")
                yield decompress(carry)
            return
        buf = carry + slab
        consumed = _complete_prefix(buf)
        carry = buf[consumed:]
        if consumed:
            yield decompress(buf[:consumed])


class StreamingBgzfWriter:
    """Bounded-memory BGZF writer producing byte-identical output to
    ``compress(whole_payload)``: uncompressed bytes buffer until whole
    64 KB blocks are available, which compress through the parallel
    codec; close() flushes the remainder and the EOF marker."""

    def __init__(self, fileobj, level: int = 6, flush_blocks: int = 256):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()
        self.flush_bytes = flush_blocks * MAX_BLOCK_SIZE

    def write(self, data: bytes) -> None:
        self.buf += data
        if len(self.buf) >= self.flush_bytes:
            whole = (len(self.buf) // MAX_BLOCK_SIZE) * MAX_BLOCK_SIZE
            with memoryview(self.buf) as mv:
                self.f.write(compress(mv[:whole], self.level, eof=False,
                                      as_view=True))
            del self.buf[:whole]

    def flush_block(self) -> None:
        """Compress and emit everything buffered so far, ending exactly
        at a block boundary (no EOF marker). Later writes start a fresh
        block, so the output is NO LONGER byte-identical to
        compress(whole_payload) — shard-gather mode only (the seam makes
        the file a pure block-concatenation target)."""
        if self.buf:
            with memoryview(self.buf) as mv:
                self.f.write(compress(mv, self.level, eof=False,
                                      as_view=True))
            self.buf = bytearray()

    def close(self) -> None:
        with memoryview(self.buf) as mv:
            self.f.write(compress(mv, self.level, eof=True, as_view=True))
        self.buf = bytearray()
