"""Plain readers of the files a job reads and writes: SAM text, BAM,
the GATK recalibration report, the Picard duplication metrics and the
GVCF. Python's standard library and numpy only."""

from __future__ import annotations

import gzip
import struct
from typing import Dict, List, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
SEQ_CODES = "=ACMGRSVTWYHKDBN"


class Reads:
    """Alignment records as columns, in file order. ``seq`` and ``qual``
    are lists of bytes (qualities as phred values, not ASCII)."""

    def __init__(self):
        self.qname: List[bytes] = []
        self.flag: List[int] = []
        self.rname: List[str] = []
        self.pos: List[int] = []
        self.mapq: List[int] = []
        self.cigar: List[List[Tuple[int, str]]] = []
        self.rnext: List[str] = []
        self.pnext: List[int] = []
        self.tlen: List[int] = []
        self.seq: List[bytes] = []
        self.qual: List[bytes] = []
        self.rg: List[str] = []

    def __len__(self) -> int:
        return len(self.qname)

    def identity(self, i: int) -> Tuple[bytes, int]:
        """(qname, first/second/neither) names a record uniquely here."""
        return self.qname[i], self.flag[i] & 0xC0

    def select(self, rows: List[int]) -> "Reads":
        """The records ``rows``, in that order."""
        out = Reads()
        for k, col in vars(self).items():
            setattr(out, k, [col[i] for i in rows])
        return out


def parse_cigar(text: str) -> List[Tuple[int, str]]:
    if text == "*":
        return []
    out, num = [], 0
    for ch in text:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, ch))
            num = 0
    return out


def read_sam(path: str) -> Tuple[List[str], Reads]:
    """(header lines, records) of a SAM text file."""
    header, r = [], Reads()
    qoff = bytes(33) + bytes(range(223))  # ASCII -> phred
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                header.append(line.rstrip(b"\n").decode())
                continue
            f = line.rstrip(b"\n").split(b"\t")
            r.qname.append(f[0])
            r.flag.append(int(f[1]))
            r.rname.append(f[2].decode())
            r.pos.append(int(f[3]))
            r.mapq.append(int(f[4]))
            r.cigar.append(parse_cigar(f[5].decode()))
            rn = f[6].decode()
            r.rnext.append(r.rname[-1] if rn == "=" else rn)
            r.pnext.append(int(f[7]))
            r.tlen.append(int(f[8]))
            r.seq.append(f[9])
            r.qual.append(f[10].translate(qoff))
            rg = ""
            for t in f[11:]:
                if t.startswith(b"RG:Z:"):
                    rg = t[5:].decode()
            r.rg.append(rg)
    return header, r


def read_bam(path: str) -> Tuple[str, List[str], Reads]:
    """(header text, reference names, records) of a BAM file."""
    with open(path, "rb") as fh:
        raw = gzip.decompress(fh.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError("%s: not a BAM file" % path)
    (l_text,) = struct.unpack_from("<i", raw, 4)
    text = raw[8 : 8 + l_text].decode()
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        names.append(raw[off + 4 : off + 4 + l_name - 1].decode())
        off += 8 + l_name
    r = Reads()
    seq_lut = [bytes(SEQ_CODES[b >> 4] + SEQ_CODES[b & 15], "ascii") for b in range(256)]
    end = len(raw)
    while off < end:
        (bs, ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq, nref, npos,
         tlen) = struct.unpack_from("<iiiBBHHHiiii", raw, off)
        p = off + 36
        r.qname.append(raw[p : p + l_name - 1])
        p += l_name
        cig = struct.unpack_from("<%dI" % n_cig, raw, p)
        r.cigar.append([(c >> 4, CIGAR_OPS[c & 15]) for c in cig])
        p += 4 * n_cig
        packed = raw[p : p + (l_seq + 1) // 2]
        r.seq.append(b"".join(seq_lut[b] for b in packed)[:l_seq])
        p += (l_seq + 1) // 2
        r.qual.append(raw[p : p + l_seq])
        p += l_seq
        tags = raw[p : off + 4 + bs]
        k = tags.find(b"RGZ")
        r.rg.append(tags[k + 3 : tags.index(b"\0", k)].decode() if k >= 0 else "")
        r.flag.append(flag)
        r.rname.append(names[ref_id] if ref_id >= 0 else "*")
        r.pos.append(pos + 1)
        r.mapq.append(mapq)
        r.rnext.append(names[nref] if nref >= 0 else "*")
        r.pnext.append(npos + 1)
        r.tlen.append(tlen)
        off += 4 + bs
    return text, names, r


def read_recal_report(path: str) -> Dict[str, Dict[tuple, tuple]]:
    """The report's RecalTable0/1/2 rows as {table: {key: values}} and the
    Quantized table's counts; numbers as printed (strings)."""
    tables: Dict[str, Dict[tuple, tuple]] = {}
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0
    nkey = {"RecalTable0": 2, "RecalTable1": 3, "RecalTable2": 5, "Quantized": 1}
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("#:") and "Table:" in ln and ln.split(":")[2] in nkey:
            name = ln.split(":")[2]
            rows = {}
            i += 2  # the name line's column header follows
            while i < len(lines) and lines[i].strip():
                f = lines[i].split()
                rows[tuple(f[: nkey[name]])] = tuple(f[nkey[name] :])
                i += 1
            tables[name] = rows
        i += 1
    return tables


def read_metrics(path: str) -> Dict[str, Dict[str, str]]:
    """Picard DuplicationMetrics rows: {library: {column: value}}."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    k = next(i for i, ln in enumerate(lines) if ln.startswith("## METRICS CLASS"))
    cols = lines[k + 1].split("\t")
    out = {}
    for ln in lines[k + 2 :]:
        if not ln.strip():
            break
        f = ln.split("\t")
        out[f[0]] = dict(zip(cols[1:], f[1:]))
    return out


def read_gvcf(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header lines, records split on tabs) of a bgzipped VCF."""
    with open(path, "rb") as fh:
        text = gzip.decompress(fh.read()).decode()
    header, recs = [], []
    for ln in text.split("\n"):
        if not ln:
            continue
        if ln.startswith("#"):
            header.append(ln)
        else:
            recs.append(ln.split("\t"))
    return header, recs


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    out, name, parts = {}, None, []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    out[name] = np.frombuffer(b"".join(parts), np.uint8).copy()
                name, parts = line[1:].split()[0].decode(), []
            else:
                parts.append(line.strip().upper())
    if name is not None:
        out[name] = np.frombuffer(b"".join(parts), np.uint8).copy()
    return out


def read_known_sites(path: str) -> Dict[str, np.ndarray]:
    """The 0-based reference positions that BQSR leaves out for a BED file
    of known sites, by contig. elPrep keeps a BED line's two numbers as
    they stand and reads them as a closed 1-based interval (intervals.go,
    bqsr.go:389-414), so the line "c 1038 1039" covers the 1-based
    positions 1038 and 1039: 0-based 1037 and 1038."""
    out: Dict[str, set] = {}
    with open(path) as fh:
        for ln in fh:
            f = ln.split("\t")
            if len(f) >= 3:
                out.setdefault(f[0], set()).update(range(int(f[1]) - 1, int(f[2])))
    return {c: np.array(sorted(v), np.int64) for c, v in out.items()}
