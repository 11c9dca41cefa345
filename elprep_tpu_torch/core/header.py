"""SAM header model.

Replicates the semantics of the reference header type and its SAM text
parser/formatter (reference: sam/sam-types.go:66-225, sam/sam-files.go:38-177,
sam/sam-files.go:412-474) so that header output is byte-equal to elPrep's.

Notable reference behaviors preserved:
- header lines are formatted with their fields sorted by tag
  (sam/sam-files.go:424-438 "sort keys so we always get the same output");
- @HD must be the first header line when present (sam/sam-files.go:93-97);
- user-defined record types are any 2-letter codes containing a lowercase
  letter (sam/sam-types.go:49-56);
- duplicate field tags within one line are an error (sam/sam-files.go:54-63).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple


class SortingOrder(str, enum.Enum):
    """Sorting orders (reference: sam/sam-types.go:96-103)."""

    KEEP = "keep"
    UNKNOWN = "unknown"
    UNSORTED = "unsorted"
    QUERYNAME = "queryname"
    COORDINATE = "coordinate"


# SAM format version written by default (reference: sam/sam-types.go:42-45).
FILE_FORMAT_VERSION = "1.6"


def is_header_user_tag(code: str) -> bool:
    """True if the record type code is user-defined, i.e. contains a
    lowercase letter (reference: sam/sam-types.go:49-56)."""
    return any("a" <= c <= "z" for c in code)


class Header:
    """The information in the header section of a SAM file.

    Each line (except @CO) is a dict mapping 2-char string tags to string
    values (reference: sam/sam-types.go:66-80).
    """

    __slots__ = ("hd", "sq", "rg", "pg", "co", "user_records")

    def __init__(self) -> None:
        self.hd: Optional[Dict[str, str]] = None
        self.sq: List[Dict[str, str]] = []
        self.rg: List[Dict[str, str]] = []
        self.pg: List[Dict[str, str]] = []
        self.co: List[str] = []
        self.user_records: Dict[str, List[Dict[str, str]]] = {}

    # -- @HD accessors (reference: sam/sam-types.go:144-199) --

    def ensure_hd(self) -> Dict[str, str]:
        if self.hd is None:
            self.hd = {"VN": FILE_FORMAT_VERSION}
        return self.hd

    def hd_so(self) -> SortingOrder:
        hd = self.ensure_hd()
        so = hd.get("SO")
        if so is not None:
            try:
                return SortingOrder(so)
            except ValueError:
                return SortingOrder.UNKNOWN
        return SortingOrder.UNKNOWN

    def set_hd_so(self, value: SortingOrder) -> None:
        hd = self.ensure_hd()
        hd.pop("GO", None)
        hd["SO"] = value.value

    def hd_go(self) -> str:
        hd = self.ensure_hd()
        return hd.get("GO", "none")

    def set_hd_go(self, value: str) -> None:
        hd = self.ensure_hd()
        hd.pop("SO", None)
        hd["GO"] = value

    def add_user_record(self, code: str, record: Dict[str, str]) -> None:
        self.user_records.setdefault(code, []).append(record)

    # -- derived info --

    def sq_ln(self, record: Dict[str, str]) -> int:
        """LN field of an @SQ record (reference: sam/sam-types.go:120-126)."""
        ln = record.get("LN")
        if ln is None:
            raise ValueError("LN entry in a SQ header line missing")
        return _parse_int32(ln)

    def contigs(self) -> Optional[List[str]]:
        """Contig names from @cs user records when this header belongs to a
        split file (reference: sam/split-merge.go:245-256), else None."""
        records = self.user_records.get("@cs")
        if not records:
            return None
        return [r["cs"] for r in records if "cs" in r]

    def clone(self) -> "Header":
        h = Header()
        h.hd = dict(self.hd) if self.hd is not None else None
        h.sq = [dict(r) for r in self.sq]
        h.rg = [dict(r) for r in self.rg]
        h.pg = [dict(r) for r in self.pg]
        h.co = list(self.co)
        h.user_records = {k: [dict(r) for r in v] for k, v in self.user_records.items()}
        return h


def _parse_int32(s: str) -> int:
    v = int(s, 10)
    if not (-(1 << 31) <= v < (1 << 31)):
        raise ValueError(f"integer {s} out of int32 range")
    return v


def _parse_header_line_fields(line: bytes) -> Dict[str, str]:
    """Parse tab-separated TAG:VALUE fields of one header line
    (reference: sam/sam-files.go:40-63)."""
    record: Dict[str, str] = {}
    if not line:
        return record
    for field in line.split(b"\t"):
        colon = field.find(b":")
        if colon != 2:
            raise ValueError(f"invalid field tag {field[:colon]!r} in SAM header line")
        tag = field[:2].decode("ascii")
        value = field[3:].decode("ascii")
        if tag in record:
            raise ValueError(f"duplicate field tag {tag} in a SAM header line")
        record[tag] = value
    return record


def parse_header_line_from_string(line: str) -> Dict[str, str]:
    """Parse a header line whose entries are separated by whitespace, as
    used for --replace-read-group (reference: sam/sam-files.go:167-177)."""
    record: Dict[str, str] = {}
    for field in line.split():
        if len(field) < 3 or field[2] != ":":
            raise ValueError(f"incorrectly formatted SAM file field {field}")
        tag, value = field[:2], field[3:]
        if tag in record:
            raise ValueError(f"duplicate field tag {tag} in a SAM header line")
        record[tag] = value
    return record


def parse_sam_header(data: bytes, start: int = 0) -> Tuple[Header, int]:
    """Parse the header section out of SAM text.

    Returns (header, offset-of-first-alignment-line). Replicates
    ParseSamHeader (reference: sam/sam-files.go:70-120).
    """
    hdr = Header()
    pos = start
    first = True
    n = len(data)
    while pos < n and data[pos : pos + 1] == b"@":
        nl = data.find(b"\n", pos)
        if nl < 0:
            raw = data[pos:]
            nl = n
        else:
            raw = data[pos:nl]
            nl += 1
        code4 = raw[:4]
        line = raw[4:]
        if code4 == b"@HD\t":
            if not first:
                raise ValueError("@HD line not in first line when parsing a SAM header")
            hdr.hd = _parse_header_line_fields(line)
        elif code4 == b"@SQ\t":
            hdr.sq.append(_parse_header_line_fields(line))
        elif code4 == b"@RG\t":
            hdr.rg.append(_parse_header_line_fields(line))
        elif code4 == b"@PG\t":
            hdr.pg.append(_parse_header_line_fields(line))
        elif code4 == b"@CO\t":
            hdr.co.append(line.decode("ascii", "surrogateescape"))
        else:
            code = raw[:3].decode("ascii", "surrogateescape")
            if code == "@CO":
                # @CO without tab separator (reference: sam/sam-files.go:107-109)
                hdr.co.append(raw[3:].decode("ascii", "surrogateescape"))
            elif is_header_user_tag(code):
                if raw[3:4] != b"\t":
                    raise ValueError(
                        f"header code {code} not followed by a tab when parsing a SAM header"
                    )
                hdr.add_user_record(code, _parse_header_line_fields(line))
            else:
                raise ValueError(f"unknown SAM record type code {code}")
        pos = nl
        first = False
    return hdr, pos


def _format_header_line(out: bytearray, code: str, record: Dict[str, str]) -> None:
    """Format one header line, fields sorted by tag
    (reference: sam/sam-files.go:424-438)."""
    out += code.encode("ascii")
    for key in sorted(record.keys()):
        out += b"\t"
        out += key.encode("ascii")
        out += b":"
        out += record[key].encode("ascii", "surrogateescape")
    out += b"\n"


def format_sam_header(hdr: Header) -> bytes:
    """Format the header section (reference: sam/sam-files.go:452-474)."""
    out = bytearray()
    if hdr.hd is not None:
        _format_header_line(out, "@HD", hdr.hd)
    for record in hdr.sq:
        _format_header_line(out, "@SQ", record)
    for record in hdr.rg:
        _format_header_line(out, "@RG", record)
    for record in hdr.pg:
        _format_header_line(out, "@PG", record)
    for comment in hdr.co:
        out += b"@CO\t"
        out += comment.encode("ascii", "surrogateescape")
        out += b"\n"
    for code, records in hdr.user_records.items():
        for record in records:
            _format_header_line(out, code, record)
    return bytes(out)
