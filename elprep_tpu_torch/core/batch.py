"""Columnar read-batch data model.

This replaces the reference's pointer-per-read ``Alignment`` struct
(reference: sam/sam-types.go:289-331) with a structure-of-arrays layout:

- fixed-width columns (``flag``, ``pos``, ``mapq``, ``pnext``, ``tlen``,
  interned name ids) live in dense numpy arrays and marshal directly into
  TPU device buffers;
- variable-length payloads (CIGAR, SEQ, QUAL, tags) live in ragged
  (flat-buffer + offsets) arrays on the host and are padded/bucketed on
  demand for device kernels;
- the reference's per-read ``Temps`` scratch map (sam/sam-types.go:330)
  becomes a dict of scratch *columns* (``temps``).

FLAG bit constants mirror sam/sam-types.go:485-522.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# FLAG bits (reference: sam/sam-types.go:485-522)
MULTIPLE = 0x1
PROPER = 0x2
UNMAPPED = 0x4
NEXT_UNMAPPED = 0x8
REVERSED = 0x10
NEXT_REVERSED = 0x20
FIRST = 0x40
LAST = 0x80
SECONDARY = 0x100
QC_FAILED = 0x200
DUPLICATE = 0x400
SUPPLEMENTARY = 0x800


def _as_offsets(lengths: np.ndarray) -> np.ndarray:
    off = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=off[1:])
    return off


@dataclass
class Ragged:
    """A ragged array: flat data buffer + int64 offsets of length N+1."""

    data: np.ndarray
    offsets: np.ndarray

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    def row(self, i: int) -> np.ndarray:
        return self.data[self.offsets[i] : self.offsets[i + 1]]

    @staticmethod
    def from_rows(rows: Sequence[np.ndarray], dtype) -> "Ragged":
        lengths = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
        off = _as_offsets(lengths)
        if len(rows):
            data = np.concatenate([np.asarray(r, dtype=dtype) for r in rows]) if off[-1] else np.zeros(0, dtype=dtype)
        else:
            data = np.zeros(0, dtype=dtype)
        return Ragged(np.asarray(data, dtype=dtype), off)

    def gather(self, idx: np.ndarray) -> "Ragged":
        """Row gather (native parallel memcpy when available)."""
        lens = self.offsets[1:] - self.offsets[:-1]
        newlens = lens[idx]
        newoff = _as_offsets(newlens)
        total = int(newoff[-1])
        if total == 0:
            return Ragged(np.zeros(0, dtype=self.data.dtype), newoff)
        starts = self.offsets[:-1][idx]
        if total > 16384:
            from .. import native

            itemsize = self.data.dtype.itemsize
            data = np.ascontiguousarray(self.data)
            fast = native.ranged_gather_u8(
                data.view(np.uint8),
                starts * itemsize, (starts + newlens) * itemsize)
            if fast is not None:
                return Ragged(fast[0].view(self.data.dtype), newoff)
        src = np.repeat(starts - newoff[:-1], newlens) + np.arange(total, dtype=np.int64)
        return Ragged(self.data[src], newoff)

    def to_padded(self, max_len: Optional[int] = None, fill=0) -> Tuple[np.ndarray, np.ndarray]:
        """Dense [N, max_len] padded view + int32 lengths, for device kernels."""
        lens = (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)
        n = len(lens)
        if max_len is None:
            max_len = int(lens.max()) if n else 0
        if n and max_len:
            from .. import native

            fast = native.ragged_to_padded(self.data, self.offsets, max_len,
                                           fill, self.data.dtype)
            if fast is not None:
                return fast, lens.astype(np.int32)
        out = np.full((n, max_len), fill, dtype=self.data.dtype)
        if n and max_len:
            cols = np.arange(max_len, dtype=np.int64)
            mask = cols[None, :] < lens[:, None]
            src = self.offsets[:-1, None] + cols[None, :]
            out[mask] = self.data[np.minimum(src, len(self.data) - 1)[mask]]
        return out, lens.astype(np.int32)

    @staticmethod
    def concat(parts: Sequence["Ragged"]) -> "Ragged":
        datas = [p.data for p in parts]
        lens = np.concatenate([p.offsets[1:] - p.offsets[:-1] for p in parts]) if parts else np.zeros(0, np.int64)
        data = np.concatenate(datas) if datas else np.zeros(0)
        return Ragged(data, _as_offsets(lens))


class TagsColumn:
    """Optional fields stored as raw SAM-format bytes per read.

    The reference parses tags eagerly into a per-read ``SmallMap``
    (sam/sam-files.go:335-346); we keep the raw bytes (flat + offsets)
    and parse lazily — canonical reformatting happens at output time in
    :mod:`elprep_tpu_torch.io.sam`.

    The raw form of one read is the tab-joined optional fields *without*
    a leading tab, e.g. ``b"RG:Z:grp1\\tNM:i:3"`` (possibly empty).
    """

    __slots__ = ("raw",)

    def __init__(self, raw: Ragged) -> None:
        self.raw = raw

    def __len__(self) -> int:
        return len(self.raw)

    def row(self, i: int) -> bytes:
        return self.raw.row(i).tobytes()

    @staticmethod
    def from_rows(rows: Sequence[bytes]) -> "TagsColumn":
        return TagsColumn(Ragged.from_rows([np.frombuffer(r, dtype=np.uint8) for r in rows], np.uint8))

    @staticmethod
    def empty(n: int) -> "TagsColumn":
        return TagsColumn(Ragged(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64)))

    def gather(self, idx: np.ndarray) -> "TagsColumn":
        return TagsColumn(self.raw.gather(idx))

    def fields(self, i: int) -> List[bytes]:
        r = self.row(i)
        return r.split(b"\t") if r else []

    def get_value_bytes(self, i: int, tag: bytes) -> Optional[bytes]:
        """Raw ``TYPE:VALUE`` bytes of tag in read i, or None."""
        for f in self.fields(i):
            if f[:2] == tag:
                return f[3:]
        return None

    def extract_z(self, tag: bytes) -> np.ndarray:
        """Vector of string-typed tag values per read (b'' if absent).

        Used for RG (dedup LIBID mapping, mark-duplicates.go:142-150) and
        similar string tags.
        """
        n = len(self)
        if n > 2048:
            from .. import native

            rng = native.extract_z_tag(self.raw.data, self.raw.offsets, tag)
            if rng is not None:
                starts, ends = rng
                w = max(int((ends - starts).max(initial=1)), 1)
                from . import batch as _b  # self-module ok

                gathered = native.ranged_gather_u8(self.raw.data, starts, ends)
                if gathered is not None:
                    flat, off = gathered
                    lens = off[1:] - off[:-1]
                    pad = native.ragged_to_padded(flat, off, w, 0, np.dtype(np.uint8))
                    if pad is not None:
                        return pad.view(f"S{w}").reshape(n)
        needle = tag + b":Z:"
        out = []
        for i in range(n):
            row = self.row(i)
            val = b""
            if row:
                # tag at start or after a tab
                j = -1
                if row.startswith(needle):
                    j = 0
                else:
                    k = row.find(b"\t" + needle)
                    if k >= 0:
                        j = k + 1
                if j >= 0:
                    end = row.find(b"\t", j)
                    if end < 0:
                        end = len(row)
                    val = row[j + 5 : end]
            out.append(val)
        return np.array(out, dtype=bytes)

    def map_rows(self, fn) -> "TagsColumn":
        """Rebuild by applying fn(raw_row_bytes) -> new_row_bytes per read."""
        return TagsColumn.from_rows([fn(self.row(i)) for i in range(len(self))])

    def extract_i(self, tag: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """(values int64, present bool) of an integer-typed tag per read."""
        n = len(self)
        vals = np.zeros(n, np.int64)
        present = np.zeros(n, bool)
        prefix = tag + b":i:"
        for i in range(n):
            for f in self.fields(i):
                if f.startswith(prefix):
                    vals[i] = int(f[5:])
                    present[i] = True
                    break
        return vals, present

    def has_tag(self, tag: bytes) -> np.ndarray:
        n = len(self)
        if n > 2048:
            # vectorized: find the 2-byte tag at a field start (row
            # start or after a tab) in the flat buffer — same semantics
            # as the per-read loop below (field[:2] == tag; values
            # cannot contain tabs in SAM)
            d = self.raw.data
            off = self.raw.offsets
            if len(d) >= 2:
                cand = np.flatnonzero((d[:-1] == tag[0]) & (d[1:] == tag[1]))
                if len(cand):
                    rows = np.searchsorted(off, cand, side="right") - 1
                    at_start = off[rows] == cand
                    prev_tab = np.zeros(len(cand), bool)
                    nz = cand > 0
                    prev_tab[nz] = d[cand[nz] - 1] == 9
                    within = cand + 2 <= off[rows + 1]
                    sel = (at_start | prev_tab) & within
                    out = np.zeros(n, bool)
                    out[rows[sel]] = True
                    return out
            return np.zeros(n, bool)
        out = np.zeros(n, bool)
        for i in range(n):
            for f in self.fields(i):
                if f[:2] == tag:
                    out[i] = True
                    break
        return out

    def remove_tags(self, tags: Sequence[bytes]) -> "TagsColumn":
        """Drop the named tags (reference: filters/simple-filters.go:235-257)."""
        tagset = set(tags)

        def fn(row: bytes) -> bytes:
            if not row:
                return row
            return b"\t".join(f for f in row.split(b"\t") if f[:2] not in tagset)

        return self.map_rows(fn)

    def keep_tags(self, tags: Sequence[bytes]) -> "TagsColumn":
        """Keep only the named tags (reference: filters/simple-filters.go:261-288)."""
        tagset = set(tags)

        def fn(row: bytes) -> bytes:
            if not row:
                return row
            return b"\t".join(f for f in row.split(b"\t") if f[:2] in tagset)

        return self.map_rows(fn)

    def set_z(self, tag: bytes, value: bytes) -> "TagsColumn":
        """Set/replace a string-typed tag in every read. Replacement happens
        in place (keeping the field position, like SmallMap.Set); a missing
        tag is appended at the end."""
        field_ = tag + b":Z:" + value

        def fn(row: bytes) -> bytes:
            if not row:
                return field_
            fields = row.split(b"\t")
            for k, f in enumerate(fields):
                if f[:2] == tag:
                    fields[k] = field_
                    return b"\t".join(fields)
            fields.append(field_)
            return b"\t".join(fields)

        return self.map_rows(fn)


@dataclass
class ReadBatch:
    """A batch of N read alignments in columnar form.

    Field semantics match the reference ``Alignment``
    (sam/sam-types.go:289-331): ``pos``/``pnext`` are 1-based, ``qual``
    holds raw Phred values (ASCII minus 33), ``seq`` holds the normalized
    base alphabet "=ACMGRSVTWYHKDBN" with everything else mapped to 'N'
    (sam/sam-types.go:227-236, sam/sam-files.go:356-372).
    """

    qname: np.ndarray  # 'S' bytes array
    flag: np.ndarray  # int32 (uint16 range)
    rname_id: np.ndarray  # int32 into names
    pos: np.ndarray  # int32
    mapq: np.ndarray  # int32 (uint8 range)
    cigar_len: Ragged  # int32 op lengths
    cigar_op: Ragged  # uint8 ASCII op chars (uppercased, adjacent-merged)
    rnext_id: np.ndarray  # int32 into names
    pnext: np.ndarray  # int32
    tlen: np.ndarray  # int32
    seq: Ragged  # uint8 ASCII
    qual: Ragged  # uint8 raw Phred
    tags: TagsColumn
    names: List[bytes]  # interned name pool for rname/rnext
    temps: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.flag)

    @property
    def n(self) -> int:
        return len(self.flag)

    def name_table(self) -> Dict[bytes, int]:
        return {nm: i for i, nm in enumerate(self.names)}

    def rname_bytes(self) -> np.ndarray:
        pool = np.array(self.names, dtype=bytes) if self.names else np.array([b""], dtype=bytes)
        return pool[self.rname_id]

    def rnext_bytes(self) -> np.ndarray:
        pool = np.array(self.names, dtype=bytes) if self.names else np.array([b""], dtype=bytes)
        return pool[self.rnext_id]

    def select(self, idx_or_mask: np.ndarray) -> "ReadBatch":
        """Row gather/compaction; also used to apply sort permutations."""
        if idx_or_mask.dtype == bool:
            idx = np.flatnonzero(idx_or_mask)
        else:
            idx = idx_or_mask
        return ReadBatch(
            qname=self.qname[idx],
            flag=self.flag[idx],
            rname_id=self.rname_id[idx],
            pos=self.pos[idx],
            mapq=self.mapq[idx],
            cigar_len=self.cigar_len.gather(idx),
            cigar_op=self.cigar_op.gather(idx),
            rnext_id=self.rnext_id[idx],
            pnext=self.pnext[idx],
            tlen=self.tlen[idx],
            seq=self.seq.gather(idx),
            qual=self.qual.gather(idx),
            tags=self.tags.gather(idx),
            names=self.names,
            temps={k: v[idx] for k, v in self.temps.items()},
        )

    @staticmethod
    def empty() -> "ReadBatch":
        z32 = np.zeros(0, np.int32)
        zr_i = Ragged(np.zeros(0, np.int32), np.zeros(1, np.int64))
        zr_u = Ragged(np.zeros(0, np.uint8), np.zeros(1, np.int64))
        return ReadBatch(
            qname=np.array([], dtype="S1"),
            flag=z32.copy(),
            rname_id=z32.copy(),
            pos=z32.copy(),
            mapq=z32.copy(),
            cigar_len=zr_i,
            cigar_op=Ragged(np.zeros(0, np.uint8), np.zeros(1, np.int64)),
            rnext_id=z32.copy(),
            pnext=z32.copy(),
            tlen=z32.copy(),
            seq=zr_u,
            qual=Ragged(np.zeros(0, np.uint8), np.zeros(1, np.int64)),
            tags=TagsColumn.empty(0),
            names=[],
        )

    @staticmethod
    def concat(parts: Sequence["ReadBatch"]) -> "ReadBatch":
        """Concatenate batches, re-interning names into a shared pool."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return ReadBatch.empty()
        pool: Dict[bytes, int] = {}
        remapped_rname = []
        remapped_rnext = []
        for p in parts:
            remap = np.array(
                [pool.setdefault(nm, len(pool)) for nm in p.names], dtype=np.int32
            ) if p.names else np.zeros(0, np.int32)
            remapped_rname.append(remap[p.rname_id] if len(p.names) else p.rname_id)
            remapped_rnext.append(remap[p.rnext_id] if len(p.names) else p.rnext_id)
        names = [None] * len(pool)
        for nm, i in pool.items():
            names[i] = nm
        qname_width = max(p.qname.dtype.itemsize for p in parts)
        # "_"-prefixed temps are per-batch caches (e.g. qname ranks)
        # whose values are only meaningful relative to ONE batch — they
        # survive select's row gather but must not concatenate
        temps_keys = set.intersection(*(set(p.temps) for p in parts)) if parts else set()
        temps_keys = {k for k in temps_keys if not k.startswith("_")}
        return ReadBatch(
            qname=np.concatenate([p.qname.astype(f"S{qname_width}") for p in parts]),
            flag=np.concatenate([p.flag for p in parts]),
            rname_id=np.concatenate(remapped_rname),
            pos=np.concatenate([p.pos for p in parts]),
            mapq=np.concatenate([p.mapq for p in parts]),
            cigar_len=Ragged.concat([p.cigar_len for p in parts]),
            cigar_op=Ragged.concat([p.cigar_op for p in parts]),
            rnext_id=np.concatenate(remapped_rnext),
            pnext=np.concatenate([p.pnext for p in parts]),
            tlen=np.concatenate([p.tlen for p in parts]),
            seq=Ragged.concat([p.seq for p in parts]),
            qual=Ragged.concat([p.qual for p in parts]),
            tags=TagsColumn(Ragged.concat([p.tags.raw for p in parts])),
            names=names,
            temps={k: np.concatenate([p.temps[k] for p in parts]) for k in temps_keys},
        )
