"""VCF model, parser and formatter (reference: vcf/vcf-types.go,
vcf/vcf-files.go).

The value model maps Go interface values to Python:

- INFO values: int, float, bool (flag), str, or list of these
  (None for missing list entries);
- Genotype: ``phased``, ``gt`` (list of allele ints, -1 for '.'),
  ``data`` an insertion-ordered dict for the non-GT FORMAT fields;
- QUAL: float or None.

Formatting is byte-exact with the reference:

- formatValue float rules (vcf-files.go:1048-1063): |v|<1e-20 -> "0.00",
  v<0.01 -> %.3e, v<1 -> %.3f, else %.2f;
- QUAL prints %.2f with a trailing ".00" stripped (vcf-files.go:1195-1207);
- percent-encoding of :;=%,\r\n\t in strings (vcf-files.go:50-71);
- trailing missing genotype fields are trimmed (vcf-files.go:1140-1182);
- header meta keys are emitted in sorted order with FORMAT/INFO blocks
  (vcf-files.go:984-1021).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

# Number kinds (reference: vcf/vcf-types.go NumberA/R/G/Dot)
NUMBER_A = -2
NUMBER_R = -3
NUMBER_G = -4
NUMBER_DOT = -5
INVALID_NUMBER = -1

_NUMBER_TO_CHAR = {NUMBER_A: "A", NUMBER_R: "R", NUMBER_G: "G", NUMBER_DOT: "."}
_CHAR_TO_NUMBER = {v: k for k, v in _NUMBER_TO_CHAR.items()}

FILE_FORMAT_LINE = "##fileformat=VCFv4.2"
DEFAULT_COLUMNS = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]

_SPECIAL_DECODE = [
    ("%3A", ":"), ("%3B", ";"), ("%3D", "="), ("%25", "%"),
    ("%2C", ","), ("%0D", "\r"), ("%0A", "\n"), ("%09", "\t"),
]
_SPECIAL_ENCODE = [
    (":", "%3A"), (";", "%3B"), ("=", "%3D"), ("%", "%25"),
    (",", "%2C"), ("\r", "%0D"), ("\n", "%0A"), ("\t", "%09"),
]


def decode_special(s: str) -> str:
    if "%" not in s:
        return s
    for k, v in _SPECIAL_DECODE:
        s = s.replace(k, v)
    return s


def encode_special(s: str) -> str:
    # single-pass like Go's strings.Replacer (no double-encoding of '%')
    out = []
    i = 0
    table = dict(_SPECIAL_ENCODE)
    while i < len(s):
        c = s[i]
        out.append(table.get(c, c))
        i += 1
    return "".join(out)


@dataclass
class FormatInformation:
    """##INFO / ##FORMAT line (reference: vcf-types.go:75-82)."""

    id: str
    description: str = ""
    number: int = INVALID_NUMBER
    type: str = ""  # Integer | Float | Flag | Character | String
    fields: Dict[str, str] = field(default_factory=dict)


@dataclass
class MetaInformation:
    id: str
    description: str = ""
    fields: Dict[str, str] = field(default_factory=dict)


@dataclass
class VcfHeader:
    file_format: str = FILE_FORMAT_LINE
    infos: List[FormatInformation] = field(default_factory=list)
    formats: List[FormatInformation] = field(default_factory=list)
    meta: Dict[str, List[Union[str, MetaInformation]]] = field(default_factory=dict)
    columns: List[str] = field(default_factory=lambda: list(DEFAULT_COLUMNS))


@dataclass
class Genotype:
    phased: bool = False
    gt: List[int] = field(default_factory=list)  # -1 for '.'
    data: Dict[str, object] = field(default_factory=dict)


@dataclass
class Variant:
    chrom: str = ""
    pos: int = -1
    id: List[str] = field(default_factory=list)
    ref: str = ""
    alt: List[str] = field(default_factory=list)
    qual: Optional[float] = None
    filter: List[str] = field(default_factory=list)
    info: Dict[str, object] = field(default_factory=dict)
    genotype_format: List[str] = field(default_factory=list)
    genotypes: List[Genotype] = field(default_factory=list)
    source: str = ""  # not part of the spec; used by HaplotypeCaller

    def end(self) -> int:
        """(reference: vcf-types.go:146-161)"""
        e = self.info.get("END")
        if e is not None:
            return int(e)
        return self.pos - 1 + len(self.ref)


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------


def format_value(v) -> str:
    """(reference: formatValue, vcf-files.go:1048-1077)"""
    if isinstance(v, bool):
        raise ValueError("unexpected boolean value")
    if isinstance(v, (int,)):
        return "%d" % v
    if isinstance(v, float):
        if v < 1:
            if v < 0.01:
                if abs(v) < 1e-20:
                    return "0.00"
                return "%.3e" % v
            return "%.3f" % v
        return "%.2f" % v
    if isinstance(v, str):
        return encode_special(v)
    raise ValueError(f"invalid value type {type(v)}")


def _format_info(info: Dict[str, object]) -> str:
    if not info:
        return "."
    parts = []
    for key, value in info.items():
        if isinstance(value, bool):
            if not value:
                raise ValueError("unexpected boolean value")
            parts.append(key)
        elif isinstance(value, (list, tuple)):
            parts.append(key + "=" + ",".join(format_value(x) for x in value))
        else:
            parts.append(key + "=" + format_value(value))
    return ";".join(parts)


def _format_genotype_entry(fmt_key: str, data: Dict[str, object]) -> Tuple[str, bool]:
    """Returns (text, present) (reference: vcf-files.go:1113-1138)."""
    value = data.get(fmt_key)
    if value is None:
        return ".", False
    if isinstance(value, (list, tuple)):
        if len(value) == 0:
            return "", True
        return ",".join("." if x is None else format_value(x) for x in value), True
    return format_value(value), True


def _format_genotype(fmt: List[str], g: Genotype) -> str:
    """(reference: formatGenotypeData, vcf-files.go:1140-1182)"""
    if not fmt:
        return ""
    out: List[str] = []
    last_present = 0
    if fmt[0] == "GT":
        sep = "|" if g.phased else "/"
        out.append(sep.join("." if n < 0 else "%d" % n for n in g.gt))
        last_present = 1
    else:
        text, ok = _format_genotype_entry(fmt[0], g.data)
        out.append(text)
        if ok:
            last_present = 1
    for i, f in enumerate(fmt[1:], start=2):
        text, ok = _format_genotype_entry(f, g.data)
        out.append(text)
        if ok:
            last_present = i
    return ":".join(out[:last_present]) if last_present else ""


_NON_REF_FMT = ["GT", "DP", "GQ", "MIN_DP", "PL"]


def format_variant(v: Variant) -> str:
    """(reference: Variant.Format, vcf-files.go:1185-1225)"""
    # fast path for the canonical GVCF reference-block shape (the vast
    # majority of records in a GVCF): output identical to the generic
    # formatter below
    if (v.genotypes and len(v.genotypes) == 1 and not v.id and not v.filter
            and v.alt == ["<NON_REF>"] and not isinstance(v.qual, float)
            and v.genotype_format == _NON_REF_FMT and v.pos >= 0
            and len(v.info) == 1):
        g = v.genotypes[0]
        end = v.info.get("END")
        if (isinstance(end, int) and not g.phased and g.gt == [0, 0]
                and len(g.data) == 4):
            try:
                pl = g.data["PL"]
                return ("%s\t%d\t.\t%s\t<NON_REF>\t.\t.\tEND=%d\t"
                        "GT:DP:GQ:MIN_DP:PL\t0/0:%d:%d:%d:%d,%d,%d\n" % (
                            v.chrom, v.pos, v.ref, end, g.data["DP"],
                            g.data["GQ"], g.data["MIN_DP"],
                            pl[0], pl[1], pl[2]))
            except (KeyError, IndexError, TypeError):
                pass
    out = [v.chrom, "\t"]
    out.append("." if v.pos < 0 else "%d" % v.pos)
    out.append("\t")
    out.append(";".join(v.id) if v.id else ".")
    out.append("\t")
    out.append(v.ref)
    out.append("\t")
    out.append(",".join(v.alt) if v.alt else ".")
    out.append("\t")
    if isinstance(v.qual, float):
        q = "%.2f" % v.qual
        if q.endswith(".00"):
            q = q[:-3]
        out.append(q)
    else:
        out.append(".")
    out.append("\t")
    out.append(";".join(v.filter) if v.filter else ".")
    out.append("\t")
    out.append(_format_info(v.info))
    if v.genotype_format:
        out.append("\t")
        out.append(":".join(v.genotype_format))
        for g in v.genotypes:
            out.append("\t")
            out.append(_format_genotype(v.genotype_format, g))
    out.append("\n")
    return "".join(out)


def _needs_quotes(s: str) -> bool:
    return '"' in s or " " in s


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _format_format_information(fi: FormatInformation, info_not_format: bool) -> str:
    out = ["<ID=", fi.id, ",Number="]
    if fi.number >= 0:
        out.append("%d" % fi.number)
    else:
        out.append(_NUMBER_TO_CHAR[fi.number])
    out.append(",Type=")
    out.append(fi.type)
    for key, value in fi.fields.items():
        out.append("," + key + "=")
        if (info_not_format and key in ("Source", "Version")) or _needs_quotes(value):
            out.append(_quote(value))
        else:
            out.append(value)
    if fi.description:
        out.append(",Description=" + _quote(fi.description))
    out.append(">")
    return "".join(out)


def _format_meta_information(m: Union[str, MetaInformation]) -> str:
    if isinstance(m, str):
        return m
    out = ["<ID=", m.id]
    for key, value in m.fields.items():
        out.append("," + key + "=")
        out.append(_quote(value) if _needs_quotes(value) else value)
    if m.description:
        out.append(",Description=" + _quote(m.description))
    out.append(">")
    return "".join(out)


def format_header(hdr: VcfHeader) -> str:
    """(reference: Header.Format, vcf-files.go:984-1021)"""
    lines = [hdr.file_format]
    keys = sorted(set(hdr.meta) | {"FORMAT", "INFO"})
    for key in keys:
        if key == "FORMAT":
            for f in hdr.formats:
                lines.append("##FORMAT=" + _format_format_information(f, False))
        elif key == "INFO":
            for f in hdr.infos:
                lines.append("##INFO=" + _format_format_information(f, True))
        else:
            for m in hdr.meta.get(key, []):
                lines.append("##" + key + "=" + _format_meta_information(m))
    lines.append("#" + "\t".join(hdr.columns))
    return "\n".join(lines) + "\n"


def iter_variant_bytes(variants):
    """Yield VCF text bytes for a writer-ready variants list. Columnar
    batches of GVCF reference blocks (hc.refconf.RefBlockBatch) format
    themselves in one native pass (format_bytes); runs of plain Variant
    records between batches join+encode as one chunk."""
    parts: List[str] = []
    for v in variants:
        if hasattr(v, "format_bytes"):
            if parts:
                yield "".join(parts).encode()
                parts = []
            yield v.format_bytes()
        else:
            parts.append(format_variant(v))
    if parts:
        yield "".join(parts).encode()


def format_vcf(hdr: VcfHeader, variants: List[Variant]) -> bytes:
    return format_header(hdr).encode() + b"".join(iter_variant_bytes(variants))


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_META_RE = re.compile(r"##([^=]+)=(.*)")


def _parse_angle_fields(s: str) -> Dict[str, str]:
    """Parse <K=V,K2="V 2",...> bodies."""
    assert s.startswith("<") and s.endswith(">")
    s = s[1:-1]
    fields: Dict[str, str] = {}
    i = 0
    n = len(s)
    while i < n:
        eq = s.index("=", i)
        key = s[i:eq]
        i = eq + 1
        if i < n and s[i] == '"':
            i += 1
            buf = []
            while i < n and s[i] != '"':
                if s[i] == "\\" and i + 1 < n:
                    i += 1
                buf.append(s[i])
                i += 1
            i += 1  # closing quote
            value = "".join(buf)
        else:
            j = i
            while j < n and s[j] != ",":
                j += 1
            value = s[i:j]
            i = j
        fields[key] = value
        if i < n and s[i] == ",":
            i += 1
    return fields


def _parse_format_information(body: str) -> FormatInformation:
    fields = _parse_angle_fields(body)
    fid = fields.pop("ID")
    desc = fields.pop("Description", "")
    num_s = fields.pop("Number", None)
    typ = fields.pop("Type", "")
    if num_s is None:
        number = INVALID_NUMBER
    elif num_s in _CHAR_TO_NUMBER:
        number = _CHAR_TO_NUMBER[num_s]
    else:
        number = int(num_s)
    return FormatInformation(id=fid, description=desc, number=number, type=typ, fields=fields)


def parse_header(lines: List[str]) -> VcfHeader:
    hdr = VcfHeader(meta={})
    for line in lines:
        if line.startswith("##"):
            m = _META_RE.match(line)
            if not m:
                raise ValueError(f"invalid meta line {line!r}")
            key, body = m.group(1), m.group(2)
            if key == "fileformat":
                hdr.file_format = line
            elif key == "INFO":
                hdr.infos.append(_parse_format_information(body))
            elif key == "FORMAT":
                hdr.formats.append(_parse_format_information(body))
            elif body.startswith("<") and body.endswith(">"):
                fields = _parse_angle_fields(body)
                mi = MetaInformation(
                    id=fields.pop("ID", ""), description=fields.pop("Description", ""),
                    fields=fields,
                )
                hdr.meta.setdefault(key, []).append(mi)
            else:
                hdr.meta.setdefault(key, []).append(line[2 + len(key) + 1 :])
        elif line.startswith("#"):
            hdr.columns = line[1:].split("\t")
    return hdr


def _typed_scalar(s: str, typ: str):
    if s == ".":
        return None
    if typ == "Integer":
        return int(s)
    if typ == "Float":
        return float(s)
    if typ == "Character":
        return s[:1]
    return decode_special(s)


def _parse_info(s: str, info_types: Dict[str, Tuple[str, int]]) -> Dict[str, object]:
    info: Dict[str, object] = {}
    if s == ".":
        return info
    for part in s.split(";"):
        if "=" in part:
            key, val = part.split("=", 1)
            typ, number = info_types.get(key, ("String", NUMBER_DOT))
            if number in (0, 1):
                info[key] = _typed_scalar(val, typ)
            else:
                info[key] = [_typed_scalar(x, typ) for x in val.split(",")]
        else:
            info[part] = True
    return info


def _parse_genotype(s: str, fmt: List[str], fmt_types: Dict[str, Tuple[str, int]]) -> Genotype:
    g = Genotype()
    vals = s.split(":")
    for key, val in zip(fmt, vals):
        if key == "GT":
            g.phased = "|" in val
            alleles = re.split(r"[/|]", val)
            g.gt = [-1 if a in (".", "") else int(a) for a in alleles]
            continue
        typ, number = fmt_types.get(key, ("String", NUMBER_DOT))
        if val == ".":
            g.data[key] = None
        elif number in (0, 1):
            g.data[key] = _typed_scalar(val, typ)
        else:
            g.data[key] = [_typed_scalar(x, typ) for x in val.split(",")]
    return g


def scan_vcf_sites(data: bytes):
    """Fast columnar site scan: {chrom: [(start0, end1)]} without
    materializing Variant objects. The reference gets conversion
    throughput from a parallel variant-parse pipeline
    (vcf/vcf-files.go:1425-1449); here the same job is a minimal-field
    byte scan (CHROM, POS, REF length, INFO END=), ~10x the full parse.
    End semantics match Variant.end(): INFO END wins, else POS+len(REF)-1."""
    out: dict = {}
    pos_of = {}
    for line in data.split(b"\n"):
        if not line or line.startswith(b"#"):
            continue
        f = line.split(b"\t", 8)
        if len(f) < 8:
            raise ValueError("too few columns in VCF line")
        chrom = f[0]
        pos = int(f[1])
        end = pos + len(f[3]) - 1
        info = f[7]
        if b"END=" in info:
            for fld in info.split(b";"):
                if fld.startswith(b"END="):
                    end = int(fld[4:])
                    break
        lst = pos_of.get(chrom)
        if lst is None:
            lst = pos_of[chrom] = out.setdefault(chrom.decode(), [])
        lst.append((pos - 1, end))
    return out


def parse_vcf(data: bytes) -> Tuple[VcfHeader, List[Variant]]:
    """Parse a whole VCF into Variant objects, serially.

    Design note — why there is deliberately NO analog of the
    reference's parallel variant-parse pipeline (vcf-files.go:1425-1449,
    a pargo LimitedPar stage over line batches): that design relies on
    Go's shared-memory goroutines. In Python the typed parse is
    GIL-bound (threads cannot help) and worker *processes* must ship
    the resulting object graph back through pickle; measured on a real
    554k-record GVCF, pickling the variants alone costs 12.5 s against
    a 12.6 s total serial parse — a process-parallel parse is strictly
    slower than serial no matter how fast the workers are (an
    8-process attempt measured 9x slower end-to-end). The paths that
    are actually hot in the pipeline avoid Variant objects entirely
    and ARE parallel/columnar: ``scan_vcf_sites`` (vcf-to-elsites) and
    the GVCF writer's native block formatter."""
    text = data.decode()
    lines = text.split("\n")
    header_lines = []
    body_start = 0
    for i, line in enumerate(lines):
        if line.startswith("#"):
            header_lines.append(line)
            body_start = i + 1
        else:
            break
    hdr = parse_header(header_lines)
    info_types = {f.id: (f.type, f.number) for f in hdr.infos}
    fmt_types = {f.id: (f.type, f.number) for f in hdr.formats}
    variants: List[Variant] = []
    for line in lines[body_start:]:
        if not line:
            continue
        variants.append(parse_variant(line, info_types, fmt_types))
    return hdr, variants


def parse_variant(line: str, info_types, fmt_types) -> Variant:
    cols = line.split("\t")
    v = Variant()
    v.chrom = cols[0]
    v.pos = -1 if cols[1] == "." else int(cols[1])
    v.id = [] if cols[2] == "." else cols[2].split(";")
    v.ref = cols[3]
    v.alt = [] if cols[4] == "." else cols[4].split(",")
    v.qual = None if cols[5] == "." else float(cols[5])
    v.filter = [] if cols[6] == "." else cols[6].split(";")
    v.info = _parse_info(cols[7], info_types)
    if len(cols) > 8:
        v.genotype_format = cols[8].split(":")
        v.genotypes = [
            _parse_genotype(c, v.genotype_format, fmt_types) for c in cols[9:]
        ]
    return v


# ---------------------------------------------------------------------------
# File-level API with .gz sniffing (reference: vcf-files.go:1285-1398)
# ---------------------------------------------------------------------------


def read_vcf_file(path: str) -> Tuple[VcfHeader, List[Variant]]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"\x1f":
        from . import bgzf

        data = bgzf.decompress(data)
    return parse_vcf(data)


def write_vcf_file(path: str, hdr: VcfHeader, variants: List[Variant]) -> None:
    body = format_vcf(hdr, variants)
    if path.endswith(".gz"):
        from . import bgzf

        body = bgzf.compress(body)
    with open(path, "wb") as f:
        f.write(body)


class StreamingVcfWriter:
    """Bounded-memory VCF/GVCF writer: variants flush incrementally
    instead of accumulating the whole record list (the reference writes
    through an ordered parallel formatting pipeline,
    haplotypecaller.go:907-944). Byte-identical to write_vcf_file on the
    same records (.gz output chops BGZF blocks at the same 64 KB
    boundaries)."""

    def __init__(self, path: str, hdr: VcfHeader, shard_sidecar: bool = False):
        self.f = open(path, "wb")
        self._bgzf = None
        if path.endswith(".gz"):
            from . import bgzf

            # small flush threshold (1 MB) so deflate streams alongside
            # variant production instead of piling up for close(); the
            # output bytes are identical (same 64 KB block boundaries)
            self._bgzf = bgzf.StreamingBgzfWriter(self.f, flush_blocks=16)
        self._write(format_header(hdr).encode())
        if shard_sidecar and self._bgzf is not None:
            # shard mode: close the header's BGZF blocks here and record
            # the compressed header length, so the shard gather
            # (_combine_vcf_outputs) can drop this shard's header and
            # concatenate its body BLOCKS without a decompress+
            # recompress round trip
            self._bgzf.flush_block()
            self.f.flush()
            with open(path + ".hdroff", "w") as s:
                s.write(str(self.f.tell()))

    def _write(self, data: bytes) -> None:
        if self._bgzf is not None:
            self._bgzf.write(data)
        else:
            self.f.write(data)

    def write_variants(self, variants) -> None:
        for chunk in iter_variant_bytes(variants):
            self._write(chunk)

    def close(self) -> None:
        if self._bgzf is not None:
            self._bgzf.close()
        self.f.close()


class AsyncVariantSink:
    """Move a variant sink's formatting + compression off the caller's
    thread: batches queue to ONE writer thread (order preserved; the
    native formatter and zlib release the GIL, so the producer keeps
    running). The caller hands over ownership of each list — mirroring
    the reference's ordered output pipeline stage
    (haplotypecaller.go:907-944) running concurrently with callRegion."""

    def __init__(self, sink, max_queue: int = 8):
        import queue
        import threading

        self._sink = sink
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._exc = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            if self._exc is not None:
                continue  # drain without writing after a failure
            try:
                self._sink.write_variants(batch)
            except BaseException as e:  # propagate on next call / close
                self._exc = e

    def _check(self) -> None:
        if self._exc is not None:
            # sticky: once a batch failed, every later write (and the
            # close) keeps raising — a swallowed error upstream must not
            # lead to a stream with a silently missing middle batch
            raise RuntimeError("variant sink failed") from self._exc

    def write_variants(self, variants) -> None:
        self._check()
        if variants:
            self._q.put(variants)

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        try:
            self._check()
        finally:
            self._sink.close()
