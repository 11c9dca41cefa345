"""Multi-device in-memory pipeline: a real ReadBatch sharded over the mesh
by contiguous refid spans (the port of elprep_tpu/parallel/sharded.py).

This replaces elPrep's sfm "distributed" mode (reference:
cmd/sfm.go:605-907): where the reference forks a subprocess per
contig-group split file and merges gob-file reductions, here the batch
shards over the mesh's devices, sort + duplicate marking run per shard on
that shard's device, and the BQSR covariate tables are summed over the
shards and, across processes, reduced with ``all_reduce`` — the
collective that replaces the ``.elrecal`` gob merge (reference:
print-bqsr.go:301-329).

Correctness structure (as in the JAX package):

- shards are *contiguous refid spans* (plus refid -1 / unmapped in the
  last shard), so concatenating per-shard coordinate-sorted outputs is
  globally sorted: the leading CoordinateLess key is the refid (with -1
  mapped after all valid ids, sam/sam-types.go:428-432);
- duplicate marking needs both mates of a pair in one shard. Like the
  reference's split files duplicate cross-group pairs with an ``sr:i:1``
  tag (split-merge.go:286-294), cross-shard pairs get *helper copies*:
  each mate's row is appended to the other mate's shard; helper verdicts
  are discarded (the home shard computes the same verdict on identical
  inputs);
- fragment duels key on the read's own refid, so helper rows (foreign
  refids) can never join a home fragment group;
- BQSR tables count home rows only; the integer scatter-add tables are
  order-independent, so their sum over shards equals the whole-file
  tables exactly.

Across processes (parallel/multihost.py) every rank parses the same input
and derives the same plan; rank ``r`` with ``D`` mesh entries runs shards
``[r*D, (r+1)*D)`` and the verdicts come back through
``all_gather_into_tensor``. In a process group (even a world of one)
the collectives run on the mesh's first device: NCCL on ``cuda``, gloo on
the CPU; without one, the shards' results are concatenated. Every
collective this process runs is recorded in ``COLLECTIVES`` as
(operation, bytes).
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..core.batch import ReadBatch
from ..core.header import Header
from .mesh import in_process_group, process_rank_and_count

MULTIPLE = 0x1
NEXT_UNMAPPED = 0x8
DUPLICATE = 0x400
ELIGIBLE_EXCLUDE = 0x4 | 0x100 | 0x800
INT32_MAX = np.int32(2**31 - 1)

COLLECTIVES: List[Tuple[str, int]] = []


def shard_spans(header: Header, n_shards: int) -> np.ndarray:
    """Map refid -> shard as contiguous spans balanced by contig length.

    Returns int32 [n_refids + 1]; the last entry is the shard of refid -1
    (unmapped), which must sort after every valid refid and therefore
    lands in the last shard (same role as the reference's "unmapped"
    contig group, split-merge.go:178-213)."""
    lens = np.array([int(sq.get("LN", "0")) for sq in header.sq], np.int64)
    n_ref = len(lens)
    if n_ref == 0:
        return np.full(1, n_shards - 1, np.int32)
    cum = np.cumsum(lens) - lens  # length before each contig
    total = max(int(lens.sum()), 1)
    shard = np.minimum((cum * n_shards) // total, n_shards - 1).astype(np.int32)
    out = np.empty(n_ref + 1, np.int32)
    out[:n_ref] = shard
    out[n_ref] = n_shards - 1  # refid -1
    return out


def _cross_shard_pairs(flag, libid, qrank, shard_of_row):
    """Rows of true pairs whose mates live in another shard.

    Joins exactly like the device program (ops/dedup.py: {LIBID, QNAME}
    candidates in arrival order). Returns (rows_a, rows_b) index arrays
    of mated rows with shard_of[a] != shard_of[b]."""
    cand = ((flag & ELIGIBLE_EXCLUDE) == 0) & \
        ((flag & (MULTIPLE | NEXT_UNMAPPED)) == MULTIPLE)
    rows = np.flatnonzero(cand)
    if len(rows) == 0:
        return rows, rows
    order = rows[np.lexsort((rows, qrank[rows], libid[rows]))]
    same = (libid[order[1:]] == libid[order[:-1]]) & \
        (qrank[order[1:]] == qrank[order[:-1]])
    # pair the first two of each {libid, qname} run (arrival order), like
    # DeleteOrStore joining (mark-duplicates.go:336-340)
    run_start = np.concatenate([[True], ~same])
    pos_in_run = np.arange(len(order)) - \
        np.maximum.accumulate(np.where(run_start, np.arange(len(order)), 0))
    second = pos_in_run % 2 == 1  # odd position pairs with its predecessor
    b_rows = order[second]
    a_rows = order[np.flatnonzero(second) - 1]
    cross = shard_of_row[a_rows] != shard_of_row[b_rows]
    return a_rows[cross], b_rows[cross]


def plan_shards(batch: ReadBatch, header: Header, n_shards: int, device=None):
    """Shard layout for a batch: per-shard row lists with helper copies.

    Returns (shard_rows, n_home, aux) where shard_rows[s] is an int64
    index array into the batch — home rows first (original order), then
    helper copies of cross-shard mates — n_home[s] is the home count, and
    aux holds the derived dedup columns (``device``: where
    ``dedup_columns`` derives them; None, the session default)."""
    from ..ops import sortkeys
    from ..ops.dedup import dedup_columns

    refid = np.asarray(batch.temps["REFID"])
    spans = shard_spans(header, n_shards)
    shard_of = spans[np.where(refid >= 0, refid, len(spans) - 1)]

    libid, upos, score, rev = dedup_columns(batch, header, device)
    qrank = sortkeys.qname_ranks(batch.qname)
    a_rows, b_rows = _cross_shard_pairs(np.asarray(batch.flag), libid, qrank,
                                        shard_of)

    # one stable counting argsort replaces n_shards flatnonzero scans
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of, minlength=n_shards)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    shard_rows: List[np.ndarray] = []
    n_home: List[int] = []
    for s in range(n_shards):
        home = order[bounds[s] : bounds[s + 1]]
        # helpers: mates of home rows that live elsewhere
        helpers = np.concatenate([
            b_rows[shard_of[a_rows] == s],
            a_rows[shard_of[b_rows] == s],
        ])
        shard_rows.append(np.concatenate([home, helpers]).astype(np.int64))
        n_home.append(len(home))
    aux = {"libid": libid, "upos": upos, "score": score, "qrank": qrank}
    return shard_rows, n_home, aux


def _round_pow2(v: int) -> int:
    n = 1
    while n < v:
        n *= 2
    return n


def _local_shards(mesh) -> List[Tuple[int, torch.device]]:
    """(global shard index, device) of every shard this process runs."""
    rank, _ = process_rank_and_count()
    return [(rank * len(mesh) + i, torch.device(d)) for i, d in enumerate(mesh)]


def _put(x: np.ndarray, shard: int, n_rows: int, device) -> torch.Tensor:
    """Rows ``[shard*n_rows, (shard+1)*n_rows)`` of the replicated host
    column ``x`` on ``device``: each process places only the shards its
    mesh owns (the counterpart of the JAX package's per-device
    ``make_array_from_callback``)."""
    part = np.ascontiguousarray(x[shard * n_rows : (shard + 1) * n_rows])
    return torch.from_numpy(part).to(device)


def _record(op: str, t: torch.Tensor) -> None:
    COLLECTIVES.append((op, t.numel() * t.element_size()))


def _all_gather(out: torch.Tensor, local: torch.Tensor) -> None:
    import torch.distributed as dist

    _record("all_gather", out)
    # all_gather_into_tensor is named all_gather_single in newer torch
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, local)


def _all_reduce(t: torch.Tensor, op: str) -> None:
    import torch.distributed as dist

    _record("all_reduce_" + op, t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)


def _check_replicated(value: int, device) -> None:
    """Raise unless every rank holds the same ``value`` (collectives of
    equal sizes need equal plans): one MAX all-reduce of (v, -v)."""
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    _all_reduce(t, "max")
    hi, neg_lo = (int(v) for v in t.cpu())
    if hi != value or -neg_lo != value:
        raise RuntimeError(f"ranks disagree on the shard plan: {value} here, "
                           f"{-neg_lo}..{hi} across ranks")


def sharded_sort_dedup_step(mesh, *cols):
    """Duplicate verdicts and the post-dedup coordinate sort permutation,
    per shard, each on its shard's device: ``mark_duplicates`` then
    ``coordinate_sort_perm`` on ``flag | dup * 0x400``.

    ``cols``: the 12 replicated host columns (flag, refid, pos, mapq,
    nrefid, pnext, tlen, qrank, libid, upos, rev, score), each int32
    [n_shards * n_pad] with shard ``s`` at rows ``[s*n_pad, (s+1)*n_pad)``.
    Every local shard is launched before any result is read back, so
    shards on different cards overlap. Returns (dup, perm): per local
    shard a device tensor each (bool, int64), in mesh order."""
    from ..ops import sortkeys
    from ..ops.dedup import mark_duplicates

    _, world = process_rank_and_count()
    n_pad = len(cols[0]) // (len(mesh) * world)
    dups, perms = [], []
    for s, dev in _local_shards(mesh):
        (flag, refid, pos, mapq, nrefid, pnext, tlen, qrank, libid, upos, rev,
         score) = (_put(c, s, n_pad, dev).to(torch.int64) for c in cols)
        dup = mark_duplicates(libid, refid, upos, rev, score, qrank, flag, device=dev)
        flag2 = flag | dup.to(torch.int64) * DUPLICATE
        perm = sortkeys.coordinate_sort_perm(flag2, refid, pos, mapq, nrefid, pnext,
                                             tlen, qrank, device=dev)
        dups.append(dup)
        perms.append(perm)
    return dups, perms


def _fetch(parts: List[torch.Tensor], mesh) -> np.ndarray:
    """The global int32 column [n_shards * n] from per-local-shard device
    tensors of n rows each: a concatenation in one process, an
    ``all_gather_into_tensor`` over the ranks (in rank order, the shard
    order) in a process group — the collective replacing the reference's
    merge of per-node output files (cmd/sfm.go:605-907)."""
    _, world = process_rank_and_count()
    if not in_process_group():
        return np.concatenate([p.to(torch.int32).cpu().numpy() for p in parts])
    dev = torch.device(mesh[0])
    local = torch.cat([p.to(device=dev, dtype=torch.int32) for p in parts])
    out = torch.empty(world * local.numel(), dtype=torch.int32, device=dev)
    _all_gather(out, local)
    return out.cpu().numpy()


def run_sharded_sort_dedup(batch: ReadBatch, header: Header, mesh,
                           do_sort: bool = True) -> Tuple[ReadBatch, dict]:
    """Sort + mark duplicates for a real ReadBatch over the mesh (a tuple
    of devices; across processes, every rank's mesh).

    Returns (coordinate-sorted batch with FLAG 0x400 set on duplicates
    and aux columns riding along as temps, aux dict for the optical
    pass) — byte-equal to the single-device mark_duplicates_batch +
    sort_batch composition. ``do_sort=False`` applies duplicate flags
    only (the sort was elided by effective_sorting_order)."""
    from ..hostpool import shared_pool as _pool

    mesh = tuple(mesh)
    _, world = process_rank_and_count()
    n_shards = len(mesh) * world
    shard_rows, n_home, aux = plan_shards(batch, header, n_shards, mesh[0])
    n_pad = _round_pow2(max(1, max(len(r) for r in shard_rows)))
    if in_process_group():
        _check_replicated(n_pad, mesh[0])

    refid = np.asarray(batch.temps["REFID"])
    nrefid = np.asarray(batch.temps["NextREFID"])
    qrank = aux["qrank"]

    def stacked(col, fill):
        col = np.asarray(col)
        out = np.full(n_shards * n_pad, fill, np.int32)
        for s, rows in enumerate(shard_rows):
            out[s * n_pad : s * n_pad + len(rows)] = col[rows]
        return out

    specs = (
        (batch.flag, 0x4),                 # dummies: unmapped, sort last
        (refid, INT32_MAX),
        (batch.pos, INT32_MAX),
        (batch.mapq, 0),
        (nrefid, INT32_MAX),
        (batch.pnext, INT32_MAX),
        (batch.tlen, 0),
        (qrank, INT32_MAX),
        (aux["libid"], -1),
        (aux["upos"], 0),
        ((np.asarray(batch.flag) >> 4) & 1, 0),
        (aux["score"], 0),
    )
    cols = tuple(_pool().map(lambda cf: stacked(*cf), specs))
    dup, perm = sharded_sort_dedup_step(mesh, *cols)
    dup = _fetch(dup, mesh).reshape(n_shards, n_pad)
    perm = _fetch(perm, mesh).reshape(n_shards, n_pad)

    # apply home-row verdicts
    flag = np.asarray(batch.flag).copy()
    for s, rows in enumerate(shard_rows):
        h = n_home[s]
        home = rows[:h]
        flag[home] = np.where(dup[s, :h] != 0, flag[home] | DUPLICATE, flag[home])
    batch.flag = flag
    # aux columns ride along as temps so the select permutes them with
    # the reads (same contract as filters.markdup.mark_duplicates_filter)
    batch.temps["LIBID"] = aux["libid"]
    batch.temps["UPOS"] = aux["upos"]
    batch.temps["DUPSCORE"] = aux["score"]
    batch.temps["QRANK"] = aux["qrank"]

    if not do_sort:
        return batch, aux

    # global sorted order: concatenate per-shard perms (home rows only)
    order_parts = []
    for s, rows in enumerate(shard_rows):
        p = perm[s]
        p = p[p < len(rows)]         # drop pad dummies
        p = p[p < n_home[s]]         # drop helper copies
        order_parts.append(rows[p])
    order = np.concatenate(order_parts) if order_parts else np.zeros(0, np.int64)
    sorted_batch = batch.select(order)
    aux_sorted = {k: v[order] for k, v in aux.items()}
    return sorted_batch, aux_sorted


def _sharded_recal_step(prep: dict, ref_classes, max_cycle: int, n_rg: int, device):
    """The six int32 covariate tables and the largest |cycle| of one
    shard's prepared columns, on ``device``: on ``cuda`` the 4-bit
    dictionary bases and bit-packed skip unpack on the card (the JAX
    package's accelerator branch); the dense build otherwise, or when the
    bases exceed a 16-symbol alphabet."""
    from ..ops import bqsr_ops
    from ..ops.packed import pack_bits, pack_nibble_dict

    cols = (prep["qual"], prep["seq_len"], prep["flag"], prep["pos"], prep["rg"],
            prep["refoff"])
    rest = (prep["op_class"], prep["op_len"], ref_classes)
    pk = pack_nibble_dict(prep["base"]) if device.type == "cuda" else None
    if pk is not None:
        return bqsr_ops.recalibrate_tables_packed(
            pk[0], pk[1], *cols, pack_bits(prep["skip"]), *rest, max_cycle=max_cycle,
            n_rg=n_rg, width=prep["base"].shape[1], device=device)
    return bqsr_ops.recalibrate_tables(prep["base"], *cols, prep["skip"], *rest,
                                       max_cycle=max_cycle, n_rg=n_rg, device=device)


def sharded_recalibrate(recal, header: Header, batch: ReadBatch, max_cycle: int,
                        mesh, timings: "dict | None" = None):
    """BQSR table build over the mesh: each local shard's home rows
    prepared on the host thread pool, its tables built on its device, the
    six tables summed (int64) over the local shards and, in a process
    group, ONE ``all_reduce(SUM)`` (and one ``MAX`` for the largest
    |cycle|) in place of the reference's gob-file table merge
    (reference: print-bqsr.go:310-329, bqsr.go:210-329).

    ``recal`` is a filters.bqsr.BaseRecalibrator. Returns the same
    BaseRecalibratorTables as the single-device path, exactly. Shards
    run independently, so each keeps its own padded shape (the JAX
    program stacks them to one).

    ``timings``, when a dict, receives wall seconds per stage (prep_s:
    threaded per-shard covariate prep; device_s: the per-shard builds,
    the local sum and the collectives, to the host-side fetch)."""
    from ..filters import bqsr as fbqsr
    from ..hostpool import shared_pool as _pool

    mesh = tuple(mesh)
    _, world = process_rank_and_count()
    n_shards = len(mesh) * world

    rgmap = fbqsr.rg_covariate_map(header)
    cov_names = sorted(set(rgmap.values()))
    tables = fbqsr.BaseRecalibratorTables.zeros(cov_names, max_cycle)
    if len(batch) == 0:
        return tables

    # shard home rows by refid span (helpers never exist here: each read
    # contributes its own bases)
    refid = np.asarray(batch.temps["REFID"])
    spans = shard_spans(header, n_shards)
    shard_of = spans[np.where(refid >= 0, refid, len(spans) - 1)]
    local = _local_shards(mesh)

    # per-shard host prep runs threaded: the clipping + covariate chain is
    # native C++ (releases the GIL), so shards prep concurrently
    t0 = time.perf_counter()
    prep = list(_pool().map(
        lambda sd: fbqsr.prep_recalibrate_columns(
            recal, header, batch, np.flatnonzero(shard_of == sd[0]), max_cycle),
        local))
    if timings is not None:
        timings["prep_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_rg = len(cov_names)
    ncyc = 2 * max_cycle + 1
    sizes = [n_rg * fbqsr.NQUAL] * 2 + [n_rg * fbqsr.NQUAL * ncyc] * 2 + \
        [n_rg * fbqsr.NQUAL * fbqsr.NCTX] * 2
    ref_classes = np.asarray(recal.ref.classes)
    # every shard launched before any is summed or read back
    outs = [_sharded_recal_step(p, ref_classes, max_cycle, n_rg, dev)
            for p, (_, dev) in zip(prep, local) if p["m"] > 0]
    dev0 = torch.device(mesh[0])
    acc = torch.zeros(sum(sizes), dtype=torch.int64, device=dev0)
    mac = torch.zeros(1, dtype=torch.int64, device=dev0)
    for out in outs:
        acc += torch.cat([t.to(device=dev0, dtype=torch.int64) for t in out[:6]])
        mac = torch.maximum(mac, out[6].to(device=dev0, dtype=torch.int64).reshape(1))
    if in_process_group():
        _all_reduce(acc, "sum")
        _all_reduce(mac, "max")
    acc = acc.cpu().numpy()
    max_abs_cycle = int(mac.cpu()[0])
    if timings is not None:
        timings["device_s"] = time.perf_counter() - t0
    if max_abs_cycle > max_cycle:
        raise ValueError("cycle value exceeds maximum cycle value")
    parts = np.split(acc, np.cumsum(sizes)[:-1])
    for name, part in zip(("qs_obs", "qs_mism", "cyc_obs", "cyc_mism", "ctx_obs",
                           "ctx_mism"), parts):
        t = getattr(tables, name)
        t += part.reshape(t.shape)
    return tables
