"""FASTA and .elfasta reference handling (reference: fasta/fasta-files.go).

.elfasta is elPrep's mmappable reference format: the 4-byte magic
31FA57A1, then per contig ``name\\t`` followed by two fixed 10-byte
slots holding Go signed varints (offset, size), then ``\\n``, then the
raw concatenated sequences (fasta-files.go:237-283). We read it with a
numpy memmap instead of the reference's unix.Mmap + goroutine.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

ELFASTA_MAGIC = b"\x31\xfa\x57\xa1"
MAX_VARINT_LEN64 = 10

# IUPAC normalization (reference: fasta-files.go:100-145)
_IUPAC_TO_N = bytes(
    c if chr(c) in "ACGTacgt" else (ord("N") if chr(c) in "NnRrYyMmKkWwSsBbDdHhVv" else c)
    for c in range(256)
)
_TO_UPPER_AND_N = bytes(
    (ord(chr(c).upper()) if chr(c) in "ACGTacgt" else (ord("N") if chr(c) in "NnRrYyMmKkWwSsBbDdHhVv" else c))
    for c in range(256)
)

# base -> int class for SNP comparison (reference: filters/bqsr.go:247-252)
BASE_TO_INT = np.zeros(256, np.uint8)
for _b, _v in ((b"aA*", 1), (b"cC", 2), (b"gG", 3), (b"tT", 4)):
    for _c in _b:
        BASE_TO_INT[_c] = _v


def _put_varint(x: int) -> bytes:
    """Go binary.PutVarint (zigzag + base-128), padded to 10 bytes."""
    ux = (x << 1) ^ (x >> 63) if x < 0 else (x << 1)
    out = bytearray()
    while ux >= 0x80:
        out.append((ux & 0x7F) | 0x80)
        ux >>= 7
    out.append(ux)
    out += b"\x00" * (MAX_VARINT_LEN64 - len(out))
    return bytes(out)


def _get_varint(data: bytes, pos: int) -> int:
    ux = 0
    shift = 0
    for i in range(MAX_VARINT_LEN64):
        b = data[pos + i]
        ux |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    x = ux >> 1
    if ux & 1:
        x = ~x
    return x


def parse_fasta(filename: str, to_upper: bool = False, to_n: bool = False) -> Dict[str, bytes]:
    """Parse a (possibly gzipped) FASTA file (reference: fasta-files.go:155-229).

    Contig name = first run of printable chars after '>'.
    """
    import gzip

    with open(filename, "rb") as fh:
        head = fh.read(1)
    opener = gzip.open if head == b"\x1f" else open
    fasta: Dict[str, bytes] = {}
    contig: Optional[str] = None
    parts = []
    trans = _TO_UPPER_AND_N if to_upper else (_IUPAC_TO_N if to_n else None)
    with opener(filename, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n").rstrip(b"\r")
            if not line:
                continue
            if line.startswith(b">"):
                if contig is not None:
                    fasta[contig] = b"".join(parts)
                contig = _contig_from_header(line)
                parts = []
            else:
                if contig is None:
                    raise ValueError(f"invalid fasta file {filename} - missing first header")
                parts.append(line.translate(trans) if trans else line)
    if contig is None:
        raise ValueError(f"empty fasta file {filename}")
    fasta[contig] = b"".join(parts)
    return fasta


def _contig_from_header(b: bytes) -> str:
    """(reference: fasta-files.go:75-89)"""
    i = 1
    while i < len(b) and not (0x21 <= b[i] <= 0x7E):
        i += 1
    j = i + 1
    while j < len(b) and (0x21 <= b[j] <= 0x7E):
        j += 1
    return b[i:j].decode("ascii")


def to_elfasta(fasta: Dict[str, bytes], filename: str) -> None:
    """Write .elfasta (reference: fasta-files.go:237-283)."""
    with open(filename, "wb") as f:
        f.write(ELFASTA_MAGIC)
        offset = len(ELFASTA_MAGIC)
        table_slots = {}
        for contig in fasta:
            f.write(contig.encode() + b"\t")
            offset += len(contig.encode()) + 1
            table_slots[contig] = offset
            f.write(b"\x00" * (2 * MAX_VARINT_LEN64))
            offset += 2 * MAX_VARINT_LEN64
        f.write(b"\n")
        offset += 1
        seq_offsets = {}
        for contig, seq in fasta.items():
            seq_offsets[contig] = offset
            f.write(seq)
            offset += len(seq)
        for contig, slot in table_slots.items():
            f.seek(slot)
            f.write(_put_varint(seq_offsets[contig]))
            f.write(_put_varint(len(fasta[contig])))


class MappedFasta:
    """Memory-mapped .elfasta (reference: fasta-files.go:286-358)."""

    def __init__(self, filename: str) -> None:
        self._mm = np.memmap(filename, dtype=np.uint8, mode="r")
        data = self._mm
        if bytes(data[: len(ELFASTA_MAGIC)]) != ELFASTA_MAGIC:
            raise ValueError(f"{filename} is not a .elfasta file - invalid magic byte sequence")
        raw = data.tobytes()  # header region scan; contigs table is tiny but offsets point into raw
        self.contigs: Dict[str, np.ndarray] = {}
        index = len(ELFASTA_MAGIC)
        while raw[index] != ord("\n"):
            start = index
            while raw[index] != ord("\t"):
                index += 1
            contig = raw[start:index].decode("ascii")
            index += 1
            off = _get_varint(raw, index)
            size = _get_varint(raw, index + MAX_VARINT_LEN64)
            self.contigs[contig] = data[off : off + size]
            index += 2 * MAX_VARINT_LEN64

    def seq(self, contig: str) -> Optional[np.ndarray]:
        """Raw base bytes for the contig (uint8 view), or None."""
        return self.contigs.get(contig)

    def close(self) -> None:
        self._mm = None
        self.contigs = {}


class RefIndex:
    """Device-friendly flattened reference: all contigs concatenated into
    one class-code array (baseToIntMap codes, bqsr.go:247-252) with
    per-contig offsets, so per-base SNP-event computation is a single
    gather on device."""

    def __init__(self, fasta: "MappedFasta | Dict[str, bytes]") -> None:
        contigs = fasta.contigs if isinstance(fasta, MappedFasta) else {
            k: np.frombuffer(v, np.uint8) for k, v in fasta.items()
        }
        self.names = list(contigs.keys())
        self.offsets: Dict[str, int] = {}
        parts = []
        off = 0
        for name, seq in contigs.items():
            self.offsets[name] = off
            parts.append(np.asarray(seq, np.uint8))
            off += len(seq)
        self.flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        self.classes = BASE_TO_INT[self.flat]
        self.total = off

    def contig_offsets_for(self, names) -> np.ndarray:
        """Offset per name (for mapping refid -> global offset); -1 if unknown."""
        return np.array([self.offsets.get(n, -1) for n in names], dtype=np.int64)
