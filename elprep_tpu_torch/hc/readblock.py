"""Columnar per-contig read blocks for the HaplotypeCaller.

The reference hands each callRegion goroutine Go ``Alignment`` pointers
(filters/haplotypecaller.go:907-944); the Python equivalent — pickling
millions of ``ClipRead`` objects across the worker-pool pipes — was the
dominant main-process cost at WGS scale. A ``ContigReadBlock`` keeps one
contig's reads as numpy columns (fast, near-zero-copy pickling), ships
slices to the pool workers, and materializes ``ClipRead`` objects only
where they are consumed.

Column semantics match ``cli._run_haplotypecaller``'s original
batch->ClipRead loop field for field.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core.batch import Ragged
from ..filters.clipping import ClipRead

_REF_CONSUME_LUT = np.zeros(256, np.int64)
for _c in b"MDN=X":
    _REF_CONSUME_LUT[_c] = 1


@dataclass
class ContigReadBlock:
    """One contig's reads in columnar form, coordinate order."""

    contig: bytes
    flag: np.ndarray  # int32
    pos: np.ndarray  # int64
    pnext: np.ndarray  # int32
    tlen: np.ndarray  # int32
    mapq: np.ndarray  # int32
    cigar_len: Ragged  # int32
    cigar_op: Ragged  # uint8 ASCII
    seq: Ragged  # uint8 ASCII
    qual: Ragged  # uint8 raw Phred
    qname: np.ndarray  # 'S' bytes array
    rnext_id: np.ndarray  # int32 into names
    names: List[bytes]
    row: np.ndarray  # int64 original batch rows

    def __len__(self) -> int:
        return len(self.flag)

    @staticmethod
    def from_batch(batch, idx: np.ndarray, contig: bytes) -> "ContigReadBlock":
        idx = np.asarray(idx, np.int64)
        return ContigReadBlock(
            contig=contig,
            flag=batch.flag[idx],
            pos=batch.pos[idx].astype(np.int64),
            pnext=batch.pnext[idx],
            tlen=batch.tlen[idx],
            mapq=batch.mapq[idx],
            cigar_len=batch.cigar_len.gather(idx),
            cigar_op=batch.cigar_op.gather(idx),
            seq=batch.seq.gather(idx),
            qual=batch.qual.gather(idx),
            qname=batch.qname[idx],
            rnext_id=batch.rnext_id[idx],
            names=list(batch.names),
            row=idx,
        )

    def select(self, idx: np.ndarray) -> "ContigReadBlock":
        idx = np.asarray(idx, np.int64)
        return ContigReadBlock(
            contig=self.contig,
            flag=self.flag[idx],
            pos=self.pos[idx],
            pnext=self.pnext[idx],
            tlen=self.tlen[idx],
            mapq=self.mapq[idx],
            cigar_len=self.cigar_len.gather(idx),
            cigar_op=self.cigar_op.gather(idx),
            seq=self.seq.gather(idx),
            qual=self.qual.gather(idx),
            qname=self.qname[idx],
            rnext_id=self.rnext_id[idx],
            names=self.names,
            row=self.row[idx],
        )

    def slice_rows(self, j: int, k: int) -> "ContigReadBlock":
        return self.select(np.arange(j, k, dtype=np.int64))

    def reference_lengths(self) -> np.ndarray:
        """Per-read reference-consumed length (MDN=X ops)."""
        cons = _REF_CONSUME_LUT[self.cigar_op.data] * self.cigar_len.data
        cum = np.concatenate([[0], np.cumsum(cons)])
        return cum[self.cigar_len.offsets[1:]] - cum[self.cigar_len.offsets[:-1]]

    def ends(self) -> np.ndarray:
        """read_end per row: pos + reference length - 1."""
        return self.pos + self.reference_lengths() - 1

    def max_reference_length(self) -> int:
        if not len(self):
            return 0
        return int(self.reference_lengths().max())

    def materialize(self) -> List[ClipRead]:
        """Build the ClipRead objects (same fields as the original
        batch->ClipRead loop). Called once per worker block."""
        n = len(self)
        out: List[ClipRead] = []
        pool = self.names if self.names else [b""]
        rname = self.contig
        ops_all = self.cigar_op.data.tobytes().decode("latin1")
        co = self.cigar_op.offsets
        clens = self.cigar_len
        seq, qual = self.seq, self.qual
        flag, pos, pnext = self.flag, self.pos, self.pnext
        tlen, mapq, qname, rnext_id = self.tlen, self.mapq, self.qname, self.rnext_id
        row = self.row
        for i in range(n):
            out.append(ClipRead(
                flag=int(flag[i]), pos=int(pos[i]), pnext=int(pnext[i]),
                tlen=int(tlen[i]), mapq=int(mapq[i]),
                cigar=list(zip(clens.row(i).tolist(), ops_all[co[i]:co[i + 1]])),
                seq=seq.row(i).tobytes(), qual=qual.row(i).tobytes(),
                rname=rname, rnext=pool[rnext_id[i]], qname=qname[i],
                row=int(row[i]),
            ))
        return out


class LazyBlockReads:
    """List-like facade over a ContigReadBlock: ClipReads materialize on
    first access and are cached (field semantics identical to
    ``materialize()``). HC worker regions that exit through the native
    ref model never touch their reads, so at typical activity rates most
    rows never materialize at all."""

    __slots__ = ("block", "_cache", "_pool", "_ops_s", "_id2idx")

    def __init__(self, block: ContigReadBlock):
        self.block = block
        self._cache: List = [None] * len(block)
        self._pool = block.names if block.names else [b""]
        self._ops_s = block.cigar_op.data.tobytes().decode("latin1")
        self._id2idx: dict = {}

    def __len__(self) -> int:
        return len(self._cache)

    def __getitem__(self, i):
        i = int(i)
        r = self._cache[i]
        if r is None:
            b = self.block
            co = b.cigar_op.offsets
            r = ClipRead(
                flag=int(b.flag[i]), pos=int(b.pos[i]),
                pnext=int(b.pnext[i]), tlen=int(b.tlen[i]),
                mapq=int(b.mapq[i]),
                cigar=list(zip(b.cigar_len.row(i).tolist(),
                               self._ops_s[co[i]:co[i + 1]])),
                seq=b.seq.row(i).tobytes(), qual=b.qual.row(i).tobytes(),
                rname=b.contig, rnext=self._pool[b.rnext_id[i]],
                qname=b.qname[i], row=int(b.row[i]))
            self._cache[i] = r
            self._id2idx[id(r)] = i
        return r

    def __iter__(self):
        for i in range(len(self._cache)):
            yield self[i]


class RegionReads:
    """A region's candidate reads as a lazy view over (LazyBlockReads,
    row indices) — materialization happens only if the region's path
    actually consumes reads (finalize/assembly)."""

    __slots__ = ("_lazy", "_rows")

    def __init__(self, lazy: LazyBlockReads, rows: np.ndarray):
        self._lazy = lazy
        self._rows = rows

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, k):
        return self._lazy[self._rows[k]]

    def __iter__(self):
        for i in self._rows:
            yield self._lazy[i]


class LazyPreclip:
    """``id(orig) -> pre-clipped template`` mapping built on demand from
    the native clip-engine columns (same templates as preclip_block's
    eager loop, constructed only for reads that reach
    finalize_assembly_region)."""

    __slots__ = ("_lazy", "_got", "_ops_s", "_templates")

    def __init__(self, lazy: LazyBlockReads, got: dict):
        self._lazy = lazy
        self._got = got
        self._ops_s = got["ops"].tobytes().decode("latin1")
        self._templates: dict = {}

    def get(self, key):
        i = self._lazy._id2idx.get(key)
        if i is None:
            return None
        t = self._templates.get(i)
        if t is None:
            got = self._got
            orig = self._lazy._cache[i]
            b = int(got["cig_base"][i])
            m = int(got["n_ops"][i])
            bs, bl = int(got["bstart"][i]), int(got["blen"][i])
            t = ClipRead(
                flag=int(got["flag"][i]), pos=int(got["pos"][i]),
                pnext=orig.pnext, tlen=orig.tlen,
                mapq=int(got["mapq"][i]),
                cigar=list(zip(got["lens"][b:b + m].tolist(),
                               self._ops_s[b:b + m])),
                seq=orig.seq[bs:bs + bl], qual=orig.qual[bs:bs + bl],
                rname=orig.rname, rnext=orig.rnext, qname=orig.qname,
                row=orig.row, base_start=orig.base_start + bs)
            self._templates[i] = t
        return t


def _native_clip_cols(block: ContigReadBlock, params):
    """Whole-block native clip (low-qual ends, soft-clip handling,
    adaptor) + the columnar context for the native refconf/activity
    region engines. Returns (got, cols) or (None, None) without the
    native lib (or on an empty block)."""
    from .. import native

    n = len(block)
    if n == 0:
        return None, None
    if not native.available() or os.environ.get("ELPREP_TPU_NO_NATIVE_CLIP"):
        return None, None
    modes = native.CLIP_LOWQ_ENDS | native.CLIP_ADAPTOR_IF_MAPPED
    modes |= (native.CLIP_SOFT_OR_REVERT if params.use_soft_clipped_bases
              else native.CLIP_SOFTCLIP)
    star = np.array([nm in (b"", b"*") for nm in block.names] or [True],
                    np.uint8)
    rnext_star = star[block.rnext_id]
    rname_star = np.full(n, 1 if block.contig in (b"", b"*") else 0, np.uint8)
    got = native.clip_reads(
        block.flag, block.pos, block.pnext, block.tlen, block.mapq,
        (block.cigar_len.data, block.cigar_op.data, block.cigar_len.offsets),
        block.qual.data, block.qual.offsets, rname_star, rnext_star,
        modes, lowq=params.min_base_qual - 1)
    if got is None:
        return None, None
    # columnar context for the native refconf region engine: the
    # post-preclip read columns plus block-level lookups computed once
    names = block.names if block.names else [b""]
    name_bad = np.array([nm != b"=" and nm != block.contig for nm in names],
                        np.uint8)
    bad_mate = (((block.flag & 0x1) != 0) & ((block.flag & 0x8) == 0)
                & (name_bad[block.rnext_id] != 0)).astype(np.uint8)
    qrank = np.unique(block.qname, return_inverse=True)[1].astype(np.int32)
    cols = dict(
        flag=got["flag"], pos=got["pos"], mapq=got["mapq"],
        n_ops=got["n_ops"], cig_base=np.ascontiguousarray(got["cig_base"]),
        lens=got["lens"], ops=got["ops"],
        bstart=got["bstart"], blen=got["blen"],
        pnext=np.ascontiguousarray(block.pnext, np.int32),
        tlen=np.ascontiguousarray(block.tlen, np.int32),
        qrank=qrank, bad_mate=bad_mate,
        seq_data=block.seq.data, seq_off=block.seq.offsets,
        qual_data=block.qual.data, qual_off=block.qual.offsets,
    )
    return got, cols


def preclip_block_lazy(block: ContigReadBlock, lazy: LazyBlockReads, params):
    """Lazy counterpart of :func:`preclip_block`: the native clip engine
    still runs ONCE over the whole block (cheap, columnar), but template
    ClipReads materialize per row on first finalize lookup. Returns
    (LazyPreclip | None, cols | None)."""
    got, cols = _native_clip_cols(block, params)
    if got is None:
        return None, None
    return LazyPreclip(lazy, got), cols


def preclip_templates(block: ContigReadBlock, block_reads, params):
    """Back-compat wrapper over :func:`preclip_block` (templates only)."""
    templates, _cols = preclip_block(block, block_reads, params)
    return templates


def preclip_block(block: ContigReadBlock, block_reads, params):
    """Run the region-independent finalize clipping steps (low-qual ends,
    soft-clip handling, adaptor; haplotypecaller.go:410-443) ONCE over
    the whole block via the native clip engine. Returns
    ``(templates, cols)``: {id(block_read): template ClipRead} for
    finalize_assembly_region's ``preclip`` argument, plus the columnar
    post-clip arrays consumed by the native refconf region engine
    (native.refconf_region). Both are None when the native lib is
    unavailable (callers then fall back to the per-region Python
    chain)."""
    got, cols = _native_clip_cols(block, params)
    if got is None:
        return ({}, None) if len(block) == 0 else (None, None)
    ops_s = got["ops"].tobytes().decode("latin1")
    lens = got["lens"]
    cig_base, n_ops = got["cig_base"], got["n_ops"]
    flag, pos, mapq = got["flag"], got["pos"], got["mapq"]
    bstart, blen = got["bstart"], got["blen"]
    out = {}
    for i, orig in enumerate(block_reads):
        b = int(cig_base[i])
        m = int(n_ops[i])
        bs, bl = int(bstart[i]), int(blen[i])
        t = ClipRead(
            flag=int(flag[i]), pos=int(pos[i]), pnext=orig.pnext,
            tlen=orig.tlen, mapq=int(mapq[i]),
            cigar=list(zip(lens[b:b + m].tolist(), ops_s[b:b + m])),
            seq=orig.seq[bs:bs + bl], qual=orig.qual[bs:bs + bl],
            rname=orig.rname, rnext=orig.rnext, qname=orig.qname,
            row=orig.row, base_start=orig.base_start + bs)
        out[id(orig)] = t
    return out, cols


def downsample_block(block: ContigReadBlock, params) -> ContigReadBlock:
    """Columnar equivalent of activity.downsample: same kept rows, same
    Java-LCG consumption (a draw per read beyond max per start;
    reference: haploutils.go:241-275)."""
    maxn = params.max_reads_per_alignment_start
    n = len(block)
    if maxn < 1 or n == 0:
        return block
    changes = np.flatnonzero(np.diff(block.pos) != 0) + 1
    starts = np.concatenate([[0], changes, [n]]).astype(np.int64)
    counts = np.diff(starts)
    if not (counts > maxn).any():
        return block  # the per-read loop draws only when a start exceeds maxn
    params.downsample_fired = True  # LCG stream advances from here on
    keep_parts: List[np.ndarray] = []
    for gi in range(len(counts)):
        s, c = int(starts[gi]), int(counts[gi])
        if c <= maxn:
            keep_parts.append(np.arange(s, s + c, dtype=np.int64))
            continue
        cur = list(range(s, s + maxn))
        for t in range(maxn, c):
            slot = params.random.int31n(t + 1)
            if slot < maxn:
                cur[slot] = s + t
        keep_parts.append(np.asarray(cur, np.int64))
    return block.select(np.concatenate(keep_parts))


def aln_slice_block(block: ContigReadBlock, region_start: int, region_end: int,
                    max_reference_length: int) -> ContigReadBlock:
    """Columnar aln_slice (haploutils.go:191-209): rows with
    pos in [region_start - max_ref_len + 1, region_end] whose read_end
    reaches region_start."""
    lowest = region_start - max_reference_length + 1
    j = int(np.searchsorted(block.pos, lowest, side="left"))
    k = int(np.searchsorted(block.pos, region_end, side="right"))
    sub = block.slice_rows(j, k)
    keep = np.flatnonzero(sub.ends() >= region_start)
    if len(keep) == len(sub):
        return sub
    return sub.select(keep)
