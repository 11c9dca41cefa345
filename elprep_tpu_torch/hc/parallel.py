"""Multi-core HaplotypeCaller orchestration.

The reference runs callRegion across all cores in a pargo pipeline
(filters/haplotypecaller.go:907-944) with the deletions side channel as
the only serial dependency (side-channel.go:26-132). Here the same
parallelism is built from a persistent pool of worker processes:

- workers run ``prepare_region`` (finalize + de Bruijn assembly + trim —
  the dominant host cost) and ``genotype_region``;
- the main process keeps the batched device PairHMM dispatch and the
  strictly ordered GVCF combiner;
- the deletions carry is handled speculatively: workers genotype with an
  assumed-empty incoming-deletions list and report whether genotyping
  read it (only a spanning-deletion ``*`` allele does). The ordered
  consumer in the main process accepts a result that never read the
  carry, with the true carry followed by the region's own entries as
  the outgoing one: until it is read the carry is only appended to. It
  re-runs a region (fresh ``prepare_region`` from the original inputs,
  reusing the already-computed PairHMM values, which depend only on the
  deterministic prepare outputs) only where genotyping read an empty
  carry and the true one is not. The carry is rarely empty (in GVCF
  mode every called site appends its ``<NON_REF>`` span) but rarely
  read, so the redo is rare too, and serial semantics stay exact.

Workers are spawned (never forked: the parent may hold a live CUDA
context) and are kept off the card: before anything touches
``torch.cuda`` a worker hides every card (``CUDA_VISIBLE_DEVICES=""``)
and makes the CPU its session device, so it only runs numpy/Python/C++
host math. The PairHMM kernel runs in the main process, fed by the
batched dispatcher of :class:`_RegionRun`. RNG safety: the
Java-compatible RNG stream is consumed only by the per-contig
downsampler in the main process, so worker scheduling cannot perturb it.

This is the counterpart of elprep_tpu/hc/parallel.py: the messages,
flow control and the cross-span pre-start are the same; the worker
set-up, the one dispatch thread and the carry's rule (a ``geno_done`` says
whether genotyping read the carry; only such a region is redone) are
the port's own.
"""

from __future__ import annotations

import bisect
import multiprocessing as mp
import os
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import trace

# regions per prepare task: small for load balance across skewed costs
PREP_TASK_SIZE = 48
# activity chunk width in reference positions (the pool path; the serial
# driver uses larger chunks)
ACT_CHUNK = 1 << 16
# PairHMM dispatch batching: accumulate pendings until this many
# (read, hap) pairs, or this many regions, share one kernel launch (values
# are padding-invariant so batching does not change results; bigger
# batches amortize the per-launch host packing and copy). One dispatch
# thread launches them: on the H100 a second one (packing while the
# other's kernel runs) did not shorten the pooled 5-step run.
PAIRHMM_PAIR_TARGET = 8192
PAIRHMM_MAX_PENDINGS = 64


# outstanding prepare tasks per worker before flow control kicks in
MAX_INFLIGHT = 8
# receipt-side bound: how many prep results may sit unconsumed in the
# main process before task refills pause — this is what limits how far
# a PRE-STARTED next span can run ahead while the current span drains
# (each buffered result is one task's terminal RefRuns or pending
# payloads, so the bound also caps buffered memory)
PRESTART_BUFFER = 8 * MAX_INFLIGHT

# the recorder's span (trace.py) of each kind of worker message
_WORKER_SPANS = {"prep": "worker.task", "geno": "worker.geno",
                 "redo": "worker.redo", "act": "worker.act"}


def _worker_main(wid: int, req_q, res_q) -> None:
    # off the card, before anything touches torch.cuda: every worker
    # imports torch (hc.driver -> ops.pairhmm -> device), and a stray
    # device lookup would otherwise open one CUDA context per worker
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from .. import device as _device

    os.environ[_device.ENV_VAR] = "cpu"
    _device.set_default_device("cpu")
    # Workers handle per-worker row ranges (~batch/N), not the whole batch:
    # cap the npalloc MAP_SHARED segment cache below the main process's
    # 24 GiB default so an N-worker pool cannot retain N*24 GiB of faulted
    # pages. An explicit user setting (inherited through spawn) still wins.
    os.environ.setdefault("ELPREP_TPU_NPALLOC_CACHE_MB", "4096")
    from .. import native as _native

    _native.tune_malloc()
    # one core per worker: the pool sizes itself to the CPU count, so a
    # worker's torch/native thread pools (each defaulting to every core)
    # would otherwise run n_workers * n_cores threads during the fanned
    # BQSR table build. Pinning also keeps each worker's caches warm.
    import torch

    torch.set_num_threads(1)
    try:
        ncpu = os.cpu_count() or 1
        os.sched_setaffinity(0, {wid % ncpu})
        _native.set_default_threads(1)
    except (AttributeError, OSError):
        pass
    _worker_loop(wid, req_q, res_q)


def _arrays_to_shm(arrays: dict, pool: "list | None" = None):
    """Copy named arrays into ONE posix shared-memory segment. Returns
    ``((shm_name, metas), shm)`` where ``metas[name] = (offset, shape,
    dtype_str)`` — the worker-side view constructor input.

    ``pool`` is an optional free-list of previously used segments:
    first-touch faults on fresh tmpfs pages can run far slower than
    warm rewrites, so reusing a span's segment for the next span keeps
    the main thread's copy cheap. A reused segment may be larger than
    needed; sizes round up to 16 MiB so consecutive spans hit the same
    segment."""
    from multiprocessing import shared_memory

    total = 0
    metas = {}
    bufs = {}
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        bufs[k] = a
        off = (total + 63) & ~63
        metas[k] = (off, a.shape, a.dtype.str)
        total = off + a.nbytes
    total = max(1, total)
    shm = None
    if pool:
        for i, cand in enumerate(pool):
            if cand.size >= total:
                shm = pool.pop(i)
                break
    if shm is None:
        shm = shared_memory.SharedMemory(
            create=True, size=(total + (16 << 20) - 1) & ~((16 << 20) - 1))
    try:
        from .. import native

        for k, a in bufs.items():
            off = metas[k][0]
            dst = np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)
            # threaded copy: a fresh segment's first-touch faults
            # parallelize across the copy threads
            if not native.parallel_copy(dst, a):
                dst[...] = a
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    return (shm.name, metas), shm


# Bound on pooled (warm) spare segments: one active span + one
# pre-started span + the recal map segment.
_SHM_POOL_SLOTS = 2


def _release_shm(pool: list, shm) -> None:
    """Return a segment to the free pool (largest kept), unlinking the
    overflow."""
    pool.append(shm)
    pool.sort(key=lambda s: s.size)
    while len(pool) > _SHM_POOL_SLOTS:
        victim = pool.pop(0)
        try:
            victim.close()
            victim.unlink()
        except Exception:
            pass


def _attach_shm_batch(desc, names):
    """Worker-side ReadBatch over a shared-memory segment written by
    :func:`_arrays_to_shm` (columns are read-only views; qname is not
    shipped — the BQSR prep never reads it)."""
    from multiprocessing import shared_memory

    from ..core.batch import Ragged, ReadBatch, TagsColumn

    shm_name, metas = desc
    shm = shared_memory.SharedMemory(name=shm_name)
    arrs = {k: np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=off)
            for k, (off, shape, dt) in metas.items()}
    n = len(arrs["flag"])
    batch = ReadBatch(
        qname=np.zeros(n, "S1"),
        flag=arrs["flag"], rname_id=arrs["rname_id"], pos=arrs["pos"],
        mapq=arrs["mapq"],
        cigar_len=Ragged(arrs["cig_len"], arrs["cig_off"]),
        cigar_op=Ragged(arrs["cig_op"], arrs["cig_off"]),
        rnext_id=arrs["rnext_id"], pnext=arrs["pnext"], tlen=arrs["tlen"],
        seq=Ragged(arrs["seq_data"], arrs["seq_off"]),
        qual=Ragged(arrs["qual_data"], arrs["qual_off"]),
        tags=TagsColumn(Ragged(arrs["tags_data"], arrs["tags_off"])),
        names=list(names))
    return shm, batch


def _attach_shm_array(name: str, shape, dtype):
    """Attach a numpy view over a posix shared-memory segment created by
    the main process. Spawned workers share the parent's resource
    tracker process, so the attach-side register is a no-op on the
    already-tracked name and the creator's unlink removes it exactly
    once — do NOT unregister here (a second removal makes the tracker
    print a KeyError)."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    return shm, np.ndarray(shape, dtype=dtype, buffer=shm.buf)


def _worker_loop(wid: int, req_q, res_q) -> None:
    from .driver import (genotype_region, genotype_region_speculative,
                         prepare_region)

    bqsr_ctx = None
    bqsr_shm, bqsr_classes = None, None

    class _Span:
        """Per-generation span state: the worker may hold the CURRENT
        span and the PREFETCHED next one simultaneously (cross-span
        overlap) — reads are shipped once per span; activity chunks and
        regions slice locally from the owning span's block."""

        __slots__ = ("params", "reference", "contig_name", "contig_length",
                     "block_reads", "preclip", "span_cols", "span_block",
                     "act_cols", "block_positions", "block_ends",
                     "max_ref_len", "store")

        def __init__(self, params, reference, contig_name, contig_length):
            self.params = params
            self.reference = reference
            self.contig_name = contig_name
            self.contig_length = contig_length
            self.block_reads = []
            self.preclip = None
            self.span_cols = None
            self.span_block = None
            self.act_cols = None
            self.block_positions = None
            self.block_ends = None
            self.max_ref_len = 0
            # rid -> ((start, end, is_active), pending, vals, keep)
            self.store: Dict[int, list] = {}

        def region_reads(self, rows):
            """Region read list: lazy view when the span is columnar
            (reads materialize only if the region's path consumes them)."""
            if self.span_block is not None:
                from .readblock import RegionReads

                return RegionReads(self.block_reads, rows)
            return [self.block_reads[i] for i in rows]

        def slice_rows(self, region_start: int, region_end: int) -> np.ndarray:
            """Vectorized aln_slice (haploutils.go:191-209): row indices
            of block reads overlapping the region — identical selection
            to activity.aln_slice, with the per-read read_end
            precomputed once per span instead of per region."""
            lowest = region_start - self.max_ref_len + 1
            j = int(np.searchsorted(self.block_positions, lowest, side="left"))
            k = int(np.searchsorted(self.block_positions, region_end,
                                    side="right"))
            return j + np.flatnonzero(self.block_ends[j:k] >= region_start)

        def make_region(self, start: int, end: int, is_active: bool):
            from .activity import AssemblyRegion

            return AssemblyRegion(
                contig=self.contig_name, reference=self.reference,
                start=start, end=end, extension=self.params.padding,
                contig_length=self.contig_length, is_active=is_active)

    refs: Dict[object, bytes] = {}
    spans: Dict[int, _Span] = {}
    # the span of the message being handled: a handler ends with
    # ``continue``, so the span ends at the top of the next turn
    busy = trace.NOOP

    try:
        while True:
            busy.__exit__(None, None, None)
            busy = trace.NOOP
            msg = req_q.get()
            kind = msg[0]
            if kind == "stop":
                return
            name = _WORKER_SPANS.get(kind)
            if name is not None and trace.enabled():
                # a prep task carries the main process's send stamp when on
                busy = (trace.span(name, regions=len(msg[4]), sent=msg[7])
                        if kind == "prep" else trace.span(name)).__enter__()
            if kind == "trace":
                # the pool switches the recorder on for a job (None: off,
                # the records dropped)
                if msg[1] is None:
                    trace.disable()
                    trace.clear()
                else:
                    trace.enable(msg[1], proc="worker")
                continue
            if kind == "trace_drain":
                trace.disable()
                res_q.put(("trace_records", None, wid, trace.drain()))
                continue
            if kind == "probe":
                # where this worker runs: its process, the cards it can
                # see, its session device, whether it opened a CUDA
                # context or joined a process group (and the rendezvous
                # variables it sees), and the CPU time it has used so far
                import torch
                import torch.distributed as dist

                from .. import device as _device

                res_q.put(("probe_done", None, wid, {
                    "pid": os.getpid(),
                    "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(_device.resolve()),
                    "cuda_initialized": torch.cuda.is_initialized(),
                    "dist_initialized": dist.is_available() and dist.is_initialized(),
                    "rendezvous_env": sorted(
                        k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                        if k in os.environ),
                    "cpu_s": time.process_time()}))
                continue
            if kind == "ref":
                _, ref_key, ref_bytes = msg
                refs[ref_key] = ref_bytes
                continue
            if kind == "drop_ref":
                refs.pop(msg[1], None)
                continue
            if kind == "span":
                _, gen, ref_key, params, contig_name, contig_length = msg
                spans[gen] = _Span(params, refs[ref_key], contig_name,
                                   contig_length)
                from .genotyping import set_randomized_qd

                set_randomized_qd(getattr(params, "randomized_qd", False))
                continue
            if kind == "drop_span":
                spans.pop(msg[1], None)
                continue
            if kind == "reads_block_shm":
                # the whole span block sits in ONE shared-memory segment;
                # this worker gathers its own row range out of it (the
                # per-worker slicing runs in the workers, in parallel,
                # instead of serially in the main process)
                _, gen, desc, contig_b, names, (j, k), max_ref_len = msg
                from multiprocessing import shared_memory

                from ..core.batch import Ragged
                from .readblock import ContigReadBlock

                shm_name, metas = desc
                shm = shared_memory.SharedMemory(name=shm_name)
                try:
                    arrs = {key: np.ndarray(shape, np.dtype(dt),
                                            buffer=shm.buf, offset=off)
                            for key, (off, shape, dt) in metas.items()}
                    whole = ContigReadBlock(
                        contig=contig_b, flag=arrs["flag"], pos=arrs["pos"],
                        pnext=arrs["pnext"], tlen=arrs["tlen"],
                        mapq=arrs["mapq"],
                        cigar_len=Ragged(arrs["cig_len"], arrs["cig_off"]),
                        cigar_op=Ragged(arrs["cig_op"], arrs["cig_off"]),
                        seq=Ragged(arrs["seq_data"], arrs["seq_off"]),
                        qual=Ragged(arrs["qual_data"], arrs["qual_off"]),
                        qname=arrs["qname"], rnext_id=arrs["rnext_id"],
                        names=list(names), row=arrs["row"])
                    payload = whole.slice_rows(j, k)
                    del whole, arrs
                finally:
                    try:
                        shm.close()
                    except BufferError:
                        pass
                res_q.put(("block_done", gen, wid))
                msg = ("reads_block", gen, payload, max_ref_len)
                # fall through to the reads_block handler below
                kind = "reads_block"
            if kind == "reads_block":
                _, gen, payload, max_ref_len = msg
                st = spans[gen]
                st.max_ref_len = max_ref_len
                if hasattr(payload, "materialize"):
                    # columnar ContigReadBlock: arrays crossed the pipe;
                    # the region-independent finalize clipping runs
                    # natively over the whole block now, while ClipReads
                    # and their pre-clip templates materialize lazily per
                    # row — regions that exit through the native ref
                    # model never build Python read objects at all
                    from .readblock import LazyBlockReads, preclip_block_lazy

                    st.block_reads = LazyBlockReads(payload)
                    st.preclip, st.span_cols = preclip_block_lazy(
                        payload, st.block_reads, st.params)
                    st.block_ends = payload.ends()
                    st.block_positions = payload.pos
                    st.span_block, st.act_cols = payload, None
                    continue
                st.block_reads = payload
                st.preclip, st.span_cols = None, None
                st.span_block, st.act_cols = None, None
                from .activity import read_end as _read_end

                st.block_ends = np.fromiter(
                    (_read_end(r) for r in st.block_reads), np.int64,
                    len(st.block_reads))
                st.block_positions = np.fromiter(
                    (r.pos for r in st.block_reads), np.int64,
                    len(st.block_reads))
                continue
            if kind == "act":
                # slice the chunk's reads from the local block with the
                # exact arguments the serial driver uses
                _, gen, tid, cs, ce = msg
                st = spans[gen]
                from .activity import (compute_activity, make_activity_cols,
                                       native_compute_activity)

                rows = st.slice_rows(cs + 1 - st.max_ref_len, ce + 1)
                res = None
                if st.span_block is not None:
                    # native one-call engine over the columnar block
                    # (bit-identical to compute_activity; fuzz-tested in
                    # tests/test_activity_native.py)
                    if st.act_cols is None:
                        st.act_cols = make_activity_cols(st.span_block)
                    res = native_compute_activity(st.act_cols, rows,
                                                  st.reference, cs + 1,
                                                  ce + 1, st.params)
                if res is None:
                    res = compute_activity(
                        [st.block_reads[i] for i in rows], st.reference,
                        cs + 1, ce + 1, st.params)
                ia, hm = res
                # ship sparse: activity is rare, and hq_mean is consumed
                # only where is_active > 0 (_band_pass_src), so dense
                # [chunk] f64 pairs (16 B/position — hundreds of MB of
                # pipe traffic at WGS scale) reduce to the hot entries
                nz = np.flatnonzero(ia)
                res_q.put(("act_done", gen, tid, len(ia),
                           nz.astype(np.int64), ia[nz], hm[nz]))
                continue
            if kind == "bqsr_ctx":
                # broadcast once per recalibrate call: known sites can be
                # dbSNP-scale, so they must not ride along with every
                # chunk, and the flattened reference class codes arrive
                # via shared memory (one copy for the whole process tree)
                _, bqsr_ctx, classes_ref = msg
                bqsr_classes = None  # drop the old view before its shm closes
                if classes_ref[0] == "shm":
                    bqsr_shm, bqsr_classes = _attach_shm_array(*classes_ref[1:])
                else:
                    bqsr_shm, bqsr_classes = None, classes_ref[1]
                continue
            if kind == "bqsr_prep":
                _, tid, sub_batch = msg
                from ..filters.bqsr import (accumulate_table_partials,
                                            prep_recalibrate_columns,
                                            rg_covariate_map)

                recal_lite, hdr, max_cycle = bqsr_ctx
                p = prep_recalibrate_columns(recal_lite, hdr, sub_batch, None,
                                             max_cycle)
                n_rg = len(set(rg_covariate_map(hdr).values()))
                part = accumulate_table_partials(
                    [p] if p["m"] > 0 else [], bqsr_classes, max_cycle, n_rg,
                    device="cpu")
                res_q.put(("bqsr_tables_done", tid, part))
                continue
            if kind == "bqsr_task":
                # the whole-batch columns arrive ONCE via shared memory;
                # this worker copies out only its own row range (native
                # gathers), so nothing batch-sized crosses the pipes
                _, tid, ctx, classes_ref, desc, names, row_range = msg
                from ..filters.bqsr import (accumulate_table_partials,
                                            prep_recalibrate_columns,
                                            rg_covariate_map)

                recal_lite, hdr, max_cycle = ctx
                bqsr_classes = None
                if classes_ref[0] == "shm":
                    bqsr_shm, bqsr_classes = _attach_shm_array(*classes_ref[1:])
                else:
                    bqsr_shm, bqsr_classes = None, classes_ref[1]
                shm2, sbatch = _attach_shm_batch(desc, names)
                try:
                    sub = sbatch.select(np.arange(row_range[0], row_range[1]))
                finally:
                    del sbatch
                    try:
                        shm2.close()
                    except BufferError:
                        pass  # a live view pins the mapping; harmless
                p = prep_recalibrate_columns(recal_lite, hdr, sub, None,
                                             max_cycle)
                n_rg = len(set(rg_covariate_map(hdr).values()))
                part = accumulate_table_partials(
                    [p] if p["m"] > 0 else [], bqsr_classes, max_cycle, n_rg,
                    device="cpu")
                res_q.put(("bqsr_tables_done", tid, part))
                continue
            if kind == "prep":
                # regions arrive as (rid0, starts, ends, actives) arrays
                # — a region is fully determined by its bounds + activity
                # plus the span context, so nothing object-shaped crosses
                # the pipe (or needs snapshotting for redo: regions
                # rebuild from the triple)
                _, gen, task_id, rid0, r_starts, r_ends, r_actives = msg[:7]
                st = spans[gen]
                out = []
                # no-variation regions of a columnar span take ONE
                # batched native call (row selection + ref model in
                # C++); everything else goes through prepare_region
                batchable = []
                rest = []
                use_batch = st.span_cols is not None and st.span_block is not None
                for i in range(len(r_starts)):
                    rid = rid0 + i
                    region = st.make_region(int(r_starts[i]), int(r_ends[i]),
                                            bool(r_actives[i]))
                    if (use_batch and not region.is_active
                            and st.params.confidence_mode != "NONE"):
                        batchable.append((rid, region))
                        continue
                    rest.append((rid, region, i))
                if batchable:
                    from .refconf import native_ref_models_batch

                    got = native_ref_models_batch(
                        st.params, [r for _, r in batchable],
                        st.block_positions, st.block_ends, st.max_ref_len,
                        st.span_cols, st.reference)
                    for (rid, region), terminal in zip(batchable, got):
                        if terminal is not None:
                            out.append((rid, "term", terminal))
                        else:
                            rest.append((rid, region, rid - rid0))
                for rid, region, i in rest:
                    rows = st.slice_rows(region.padded_start(),
                                         region.padded_end())
                    if st.span_cols is not None:
                        # lazy: with the columnar finalize + ref-model
                        # fast paths most regions never materialize
                        # Python read objects
                        fill = (lambda r, _rows=rows:
                                setattr(r, "reads", st.region_reads(_rows)))
                    else:
                        region.reads = st.region_reads(rows)
                        fill = None
                    terminal, pending = prepare_region(
                        st.params, region, st.preclip, span_cols=st.span_cols,
                        span_rows=rows, span_reference=st.reference,
                        fill_reads=fill)
                    if pending is None:
                        out.append((rid, "term", terminal))
                    else:
                        st.store[rid] = [(int(r_starts[i]), int(r_ends[i]),
                                          bool(r_actives[i])), pending,
                                         None, None]
                        out.append((rid, "pend", pending.reads_in,
                                    pending.hap_bases, pending.hap_is_ref))
                # pre-concatenate adjacent terminal RefRuns: the ordered
                # consumer's run buffer sees ONE run per maximal adjacent
                # group instead of one per region (concat_ref_runs is
                # associative over adjacent runs, so the merged banding
                # output is identical — see its docstring)
                from .refconf import RefRun, concat_ref_runs

                def _solo_run(it):
                    return (it[1] == "term" and len(it[2]) == 1
                            and isinstance(it[2][0], RefRun))

                out.sort(key=lambda it: it[0])
                i = 0
                while i < len(out):
                    if not _solo_run(out[i]):
                        i += 1
                        continue
                    group = [out[i][2][0]]
                    j = i + 1
                    while (j < len(out) and out[j][0] == out[j - 1][0] + 1
                           and _solo_run(out[j])
                           and group[-1].pos0 + len(group[-1])
                           == out[j][2][0].pos0):
                        group.append(out[j][2][0])
                        j += 1
                    if len(group) > 1:
                        out[i] = (out[i][0], "term", [concat_ref_runs(group)])
                        for k in range(i + 1, j):
                            out[k] = (out[k][0], "term", [])
                    i = j
                res_q.put(("prep_done", gen, wid, task_id, out))
                continue
            if kind == "geno":
                _, gen, rid, vals, keep = msg
                st = spans[gen]
                ent = st.store[rid]
                ent[2], ent[3] = vals, keep
                res_q.put(("geno_done", gen, rid)
                          + genotype_region_speculative(st.params, ent[1],
                                                        vals, keep))
                continue
            if kind == "redo":
                # speculative genotyping mutated the pending (realign):
                # rebuild it from the stored (start, end, is_active)
                # triple and rerun with the true incoming deletions;
                # prepare is deterministic so the stored PairHMM values
                # still apply
                _, gen, rid, incoming = msg
                st = spans[gen]
                ent = st.store[rid]
                region = st.make_region(*ent[0])
                rows = st.slice_rows(region.padded_start(),
                                     region.padded_end())
                region.reads = st.region_reads(rows)
                _terminal, pending = prepare_region(
                    st.params, region, st.preclip, span_cols=st.span_cols,
                    span_rows=rows, span_reference=st.reference)
                assert pending is not None, "redo of a terminal region"
                variants, outgoing = genotype_region(st.params, pending,
                                                     ent[2], ent[3],
                                                     list(incoming))
                # final: the consumer takes a redo's result as it is
                res_q.put(("geno_done", gen, rid, variants, outgoing, True))
                continue
            raise ValueError(f"unknown message {kind!r}")
    except Exception:
        res_q.put(("error", wid, traceback.format_exc()))


class HCWorkerPool:
    """Persistent spawn-based worker pool for region processing."""

    def __init__(self, n_workers: int):
        ctx = mp.get_context("spawn")
        self.n = n_workers
        self._next_gen = 0
        self._ref_live: Dict[object, int] = {}
        self._span_ref: Dict[int, object] = {}
        self._bounds: Dict[int, List[int]] = {}
        self._buf: Dict[int, list] = {}
        self._act_expect: Dict[int, int] = {}
        self._act_results: Dict[int, dict] = {}
        self._act_seen: Dict[int, int] = {}
        self._runs: Dict[int, "_RegionRun"] = {}
        self._span_shm: Dict[int, list] = {}  # gen -> [shm, pending acks]
        self._shm_pool: list = []  # warm spare segments for reuse
        self.res_q = ctx.Queue()
        self.req_qs = [ctx.Queue() for _ in range(n_workers)]
        self.procs = [
            ctx.Process(target=_worker_main, args=(i, self.req_qs[i], self.res_q),
                        daemon=True)
            for i in range(n_workers)
        ]
        for p in self.procs:
            p.start()

    def close(self) -> None:
        for q in self.req_qs:
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        for gen, (shm, _pending) in list(self._span_shm.items()):
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self._span_shm.clear()
        for shm in self._shm_pool:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self._shm_pool.clear()

    def _recv_raw(self, extra_check=None):
        # the wait for a message and its read are separate spans: poll the
        # queue's pipe (only this thread reads it), then get
        reader = self.res_q._reader
        while True:
            if not reader.poll():
                with trace.span("hc.wait"):
                    # short timeout: the empty branch is also the worker
                    # failure detector, and 10s bounds how long a crashed
                    # worker can leave the main process waiting
                    ready = reader.poll(10)
                if not ready:
                    if extra_check is not None:
                        extra_check()
                    dead = [i for i, p in enumerate(self.procs) if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"HC worker(s) {dead} died unexpectedly")
                    continue
            with trace.span("hc.recv"):
                msg = self.res_q.get()
            if msg[0] == "error":
                raise RuntimeError(f"HC worker {msg[1]} failed:\n{msg[2]}")
            if msg[0] == "prep_done":
                # flow control at RECEIPT: refill the worker immediately,
                # whether this message is for the active consumer or a
                # pre-started next span whose results are only buffered
                run = self._runs.get(msg[1])
                if run is not None:
                    run.note_prep_done(msg[2], msg[3])
            if msg[0] == "block_done":
                # every worker copied its rows out of the span's shared
                # block segment: release it
                gen = msg[1]
                ent = self._span_shm.get(gen)
                if ent is not None:
                    ent[1] -= 1
                    if ent[1] <= 0:
                        del self._span_shm[gen]
                        _release_shm(self._shm_pool, ent[0])
                continue
            return msg

    def _recv_routed(self, want_kinds, gen, extra_check=None):
        """Receive the next message of a wanted kind for ``gen``,
        buffering everything else (messages from a prefetched span
        arrive interleaved with the active span's results)."""
        buf = self._buf.setdefault(gen, [])
        for i, msg in enumerate(buf):
            if msg[0] in want_kinds:
                return buf.pop(i)
        while True:
            msg = self._recv_raw(extra_check)
            if msg[1] == gen and msg[0] in want_kinds:
                return msg
            if msg[0] == "act_done":
                self._act_seen[msg[1]] = self._act_seen.get(msg[1], 0) + 1
            self._buf.setdefault(msg[1], []).append(msg)

    # -- span lifecycle (generation-tagged so the NEXT span's reference
    # broadcast / block distribution / activity runs in the workers
    # while the main process drains the current span) ------------------

    def new_span(self, params, reference: bytes, contig: str,
                 contig_length: int, ref_key=None) -> int:
        """Create a worker-side span generation. ``ref_key`` identifies
        the reference so consecutive spans of one contig ship its bytes
        only once; refs are dropped when their last span is dropped."""
        gen = self._next_gen
        self._next_gen += 1
        if ref_key is None:
            ref_key = ("anon", gen)
        if ref_key not in self._ref_live:
            self._ref_live[ref_key] = 0
            for q in self.req_qs:
                q.put(("ref", ref_key, reference))
        self._ref_live[ref_key] += 1
        self._span_ref[gen] = ref_key
        self._bounds[gen] = []
        for q in self.req_qs:
            q.put(("span", gen, ref_key, params, contig, contig_length))
        return gen

    def drop_span(self, gen: int) -> None:
        # the span's shared block segment must not outlive the span: if
        # some worker's copied-out ack is still in flight, drain for it
        # (acks precede any prep/act result of the same span in each
        # worker's FIFO, so they are already sent or imminent). Bounded:
        # a missing ack must degrade to a leaked-name unlink, never a
        # hang (observed twice as a rare full-suite deadlock — every
        # worker idle, the segment's pending count stuck >0). Unlinking
        # (not pooling) the segment keeps the degraded path safe: a
        # worker still copying would hit FileNotFoundError -> "error"
        # -> surfaced, instead of racing a pooled reuse.
        deadline = time.monotonic() + 60.0

        class _AckTimeout(Exception):
            pass

        def _deadline_check():
            # runs on every empty-queue wakeup inside _recv_raw
            if time.monotonic() > deadline:
                raise _AckTimeout

        try:
            while gen in self._span_shm:
                _deadline_check()
                msg = self._recv_raw(extra_check=_deadline_check)
                self._buf.setdefault(msg[1], []).append(msg)
        except _AckTimeout:
            ent = self._span_shm.pop(gen, None)
            if ent is not None:
                import sys as _sys

                print("elprep_tpu_torch: warning: span %d block-ack timeout "
                      "(%d outstanding); unlinking segment instead of "
                      "pooling it" % (gen, ent[1]), file=_sys.stderr,
                      flush=True)
                try:
                    ent[0].close()
                    ent[0].unlink()
                except Exception:
                    pass
        for q in self.req_qs:
            q.put(("drop_span", gen))
        ref_key = self._span_ref.pop(gen, None)
        if ref_key is not None:
            self._ref_live[ref_key] -= 1
            if self._ref_live[ref_key] == 0:
                del self._ref_live[ref_key]
                for q in self.req_qs:
                    q.put(("drop_ref", ref_key))
        self._bounds.pop(gen, None)
        self._buf.pop(gen, None)
        self._act_expect.pop(gen, None)
        self._act_results.pop(gen, None)
        self._act_seen.pop(gen, None)
        self._runs.pop(gen, None)

    def distribute_span(self, gen: int, reads, positions, max_ref_len: int,
                        params=None) -> None:
        """Partition the span's reads into per-worker contiguous blocks
        (equal read counts; boundaries by position) and ship each block
        ONCE. Activity chunks and regions route to the block owning
        their start position and slice reads locally — the read data
        crosses the pipes once per span instead of once per task."""
        is_block = hasattr(reads, "materialize")

        shm_desc = None
        if is_block and self.n > 1 and len(reads) > 0:
            # ship the WHOLE block via one shared-memory segment: each
            # worker gathers its own row range out of it, so the
            # per-worker slicing runs in the workers in parallel instead
            # of serially here (and nothing block-sized rides the pipes)
            try:
                shm_desc, shm = _arrays_to_shm(dict(
                    flag=reads.flag, pos=reads.pos, pnext=reads.pnext,
                    tlen=reads.tlen, mapq=reads.mapq,
                    cig_len=reads.cigar_len.data,
                    cig_off=reads.cigar_len.offsets,
                    cig_op=reads.cigar_op.data,
                    seq_data=reads.seq.data, seq_off=reads.seq.offsets,
                    qual_data=reads.qual.data, qual_off=reads.qual.offsets,
                    qname=reads.qname, rnext_id=reads.rnext_id,
                    row=reads.row), pool=self._shm_pool)
                self._span_shm[gen] = [shm, self.n]
            except Exception:
                shm_desc = None

        def ship(w: int, j: int, k: int) -> None:
            if shm_desc is not None:
                self.req_qs[w].put(("reads_block_shm", gen, shm_desc,
                                    reads.contig, reads.names, (j, k),
                                    max_ref_len))
            elif is_block:
                self.req_qs[w].put(("reads_block", gen,
                                    reads.slice_rows(j, k), max_ref_len))
            else:
                self.req_qs[w].put(("reads_block", gen, list(reads[j:k]),
                                    max_ref_len))

        n = len(reads)
        if n == 0 or self.n == 1:
            self._bounds[gen] = []
            ship(0, 0, n)
            for w in range(1, self.n):
                self.req_qs[w].put(("reads_block", gen, [], max_ref_len))
            return
        bounds = sorted({int(positions[(w * n) // self.n])
                         for w in range(1, self.n)})
        self._bounds[gen] = bounds
        # margins proven by the slice formulas: activity chunks need
        # positions >= start - 2*max_ref_len + 2 and < end + ACT_CHUNK + 1;
        # regions (<= max_region_size, padded by `extension`) need
        # start - extension - max_ref_len .. start + max_region_size +
        # extension — derived from params so non-default padding cannot
        # silently truncate block-boundary reads
        ext = getattr(params, "padding", 100) if params is not None else 100
        mrs = getattr(params, "max_region_size", 300) if params is not None else 300
        ml = 2 * max_ref_len + ext + 512
        mr = ACT_CHUNK + mrs + ext + 512
        nb = len(bounds)  # may be < n-1 when quantile positions collide
        for w in range(self.n):
            if w > nb:
                ship(w, 0, 0)  # empty block (still acks the shm segment)
                continue
            lo_b = None if w == 0 else bounds[w - 1]
            hi_b = None if w >= nb else bounds[w]
            j = 0 if lo_b is None else int(np.searchsorted(positions, lo_b - ml,
                                                           side="left"))
            k = n if hi_b is None else int(np.searchsorted(positions, hi_b + mr,
                                                           side="right"))
            ship(w, j, k)

    def owner_of(self, gen: int, start_pos: int) -> int:
        bounds = self._bounds[gen]
        if not bounds:
            return 0
        return min(bisect.bisect_right(bounds, start_pos), self.n - 1)

    def send_activity(self, gen: int, chunks) -> None:
        """Scatter activity chunks (cs, ce) over the block owners;
        results gather later via collect_activity (possibly while a
        previous span is still draining)."""
        self._act_expect[gen] = len(chunks)
        self._act_results[gen] = {}
        for tid, (cs, ce) in enumerate(chunks):
            self.req_qs[self.owner_of(gen, cs)].put(("act", gen, tid, cs, ce))

    def activity_ready(self, gen: int) -> bool:
        """True when every activity chunk of ``gen`` has already arrived
        (buffered) — collect_activity will not block."""
        want = self._act_expect.get(gen)
        return want is not None and self._act_seen.get(gen, 0) >= want

    def probe_workers(self) -> List[dict]:
        """Each worker's report of where it runs (pid, visible cards,
        session device, CUDA context) and its CPU seconds so far, in
        worker order. Call between runs."""
        for q in self.req_qs:
            q.put(("probe",))
        out: List[Optional[dict]] = [None] * self.n
        for _ in range(self.n):
            msg = self._recv_routed(("probe_done",), None)
            out[msg[2]] = msg[3]
        return out

    def trace_workers(self, job) -> None:
        """Switch the workers' span recorders on for ``job`` (None: off,
        their records dropped)."""
        for q in self.req_qs:
            q.put(("trace", job))

    def drain_traces(self) -> None:
        """Switch the workers' recorders off and merge their records into
        this process's recorder."""
        for q in self.req_qs:
            q.put(("trace_drain",))
        for _ in range(self.n):
            trace.merge(self._recv_routed(("trace_records",), None)[3])

    def collect_activity(self, gen: int):
        """Gather (is_active, hq_mean) per chunk, in chunk order."""
        want = self._act_expect.pop(gen)
        self._act_seen.pop(gen, None)
        got = self._act_results.pop(gen)
        while len(got) < want:
            msg = self._recv_routed(("act_done",), gen)
            _, _, tid, n, nz, ia_v, hm_v = msg
            ia = np.zeros(n, np.float64)
            hm = np.zeros(n, np.float64)
            ia[nz] = ia_v
            hm[nz] = hm_v
            got[tid] = (ia, hm)
        return [got[tid] for tid in range(want)]

    def map_bqsr_tables(self, recal_lite, header, batch, max_cycle: int,
                        ref_classes):
        """Chunk the batch over the workers for the BQSR table build:
        each worker runs the host prep (eligibility + adaptor/soft-clip
        hard clipping + covariate columns) AND the CPU route's table
        build (the native engine) on its chunk, returning only the
        partial tables (a few hundred KB)
        — per-read columns never cross the result pipes. The reference
        class codes ship once via posix shared memory. Scatter-adds
        commute, so summed partials equal the whole-batch build."""
        shm = None
        try:
            from multiprocessing import shared_memory

            arr = np.ascontiguousarray(ref_classes)
            shm = shared_memory.SharedMemory(create=True,
                                             size=max(1, arr.nbytes))
            np.ndarray(arr.shape, dtype=arr.dtype, buffer=shm.buf)[...] = arr
            classes_ref = ("shm", shm.name, arr.shape, arr.dtype)
        except Exception:
            if shm is not None:
                shm.close()
                shm.unlink()
                shm = None
            classes_ref = ("inline", ref_classes)
        batch_shm = None
        desc = None
        try:
            from multiprocessing import shared_memory as _sm  # noqa: F401

            desc, batch_shm = _arrays_to_shm(dict(
                flag=batch.flag, pos=batch.pos, pnext=batch.pnext,
                tlen=batch.tlen, mapq=batch.mapq,
                rname_id=batch.rname_id, rnext_id=batch.rnext_id,
                cig_len=batch.cigar_len.data,
                cig_off=batch.cigar_len.offsets,
                cig_op=batch.cigar_op.data,
                seq_data=batch.seq.data, seq_off=batch.seq.offsets,
                qual_data=batch.qual.data, qual_off=batch.qual.offsets,
                tags_data=batch.tags.raw.data,
                tags_off=batch.tags.raw.offsets,
            ), pool=self._shm_pool)
        except Exception:
            if batch_shm is not None:
                batch_shm.close()
                batch_shm.unlink()
            desc, batch_shm = None, None
        try:
            n = len(batch)
            chunk = max(1, (n + self.n - 1) // self.n)
            n_chunks = (n + chunk - 1) // chunk
            tids = 0
            if desc is not None:
                # whole-batch columns via ONE shared-memory segment;
                # workers copy out their own row range. Workers attach
                # before replying and the unlink below happens only
                # after every reply, so attach-after-unlink cannot occur.
                ctx = (recal_lite, header, max_cycle)
                for w, lo in enumerate(range(0, n, chunk)):
                    self.req_qs[w % self.n].put(
                        ("bqsr_task", tids, ctx, classes_ref, desc,
                         batch.names, (lo, min(lo + chunk, n))))
                    tids += 1
            else:
                # fallback: pickle per-worker sub-batches through the pipes
                for w in range(min(n_chunks, self.n)):
                    self.req_qs[w].put(
                        ("bqsr_ctx", (recal_lite, header, max_cycle),
                         classes_ref))
                for w, lo in enumerate(range(0, n, chunk)):
                    sub = batch.select(np.arange(lo, min(lo + chunk, n)))
                    self.req_qs[w % self.n].put(("bqsr_prep", tids, sub))
                    tids += 1
            out = [None] * tids
            got = 0
            while got < tids:
                msg = self._recv_raw()
                assert msg[0] == "bqsr_tables_done", msg[0]
                out[msg[1]] = msg[2]
                got += 1
            return out
        finally:
            if shm is not None:
                shm.close()
                shm.unlink()
            if batch_shm is not None:
                # keep the warm segment for the HC spans that follow
                _release_shm(self._shm_pool, batch_shm)

    def start_regions(self, gen, params, regions, use_device_pairhmm
                      ) -> "_RegionRun":
        """Create a region-processing run for ``gen`` and send its first
        round of prepare tasks. The caller consumes results later via
        ``run.results(deletions)`` — in between, the workers already
        prepare this span (receipt-side flow control in _recv_raw keeps
        refilling them even while another span's run is being consumed)."""
        run = _RegionRun(self, gen, params, regions, use_device_pairhmm)
        self._runs[gen] = run
        return run

class _RegionRun:
    """One span's region-processing pipeline: prepare-task scheduling,
    batched PairHMM dispatch, speculative genotyping with the ordered
    deletions-carry redo, and the ordered result generator."""

    def __init__(self, pool: HCWorkerPool, gen, params, regions,
                 use_device_pairhmm):
        from collections import deque

        self.pool = pool
        self.gen = gen
        self.regions = regions
        self.use_device_pairhmm = use_device_pairhmm

        n = self.n = len(regions)
        # results per rid
        self.term: Dict[int, list] = {}
        self.pend_inputs: Dict[int, tuple] = {}
        self.owner: Dict[int, int] = {}
        self.geno: Dict[int, tuple] = {}
        self.redo_sent: set = set()

        # build prepare tasks: consecutive regions grouped while they
        # share a block owner (regions route to the worker holding their
        # reads; regions ship BARE — the owner slices reads locally)
        tasks: List[List[int]] = []
        cur: List[int] = []
        cur_owner = -1
        for rid in range(n):
            w = pool.owner_of(gen, regions[rid].start)
            if cur and (w != cur_owner or len(cur) >= PREP_TASK_SIZE):
                tasks.append(cur)
                cur = []
            cur_owner = w
            cur.append(rid)
            self.owner[rid] = w
        if cur:
            tasks.append(cur)
        self.tasks = tasks
        self.wtasks = [deque() for _ in range(pool.n)]
        for t, rids in enumerate(tasks):
            self.wtasks[self.owner[rids[0]]].append(t)
        self.inflight = [0] * pool.n
        # with the recorder on: receipt time (perf_counter_ns) of each
        # prep result by task, then of each pending region by rid
        self.received: Dict[int, int] = {}
        self.pend_received: Dict[int, int] = {}
        self.preps_received = 0
        self.preps_unconsumed = len(tasks)
        self.pending_batch: List[int] = []
        self.ph_pool = None
        self.ph_futures: List = []
        self.send_tasks()

    def send_tasks(self) -> None:
        # per-worker queues: every worker's pipeline fills up to
        # MAX_INFLIGHT independently of the others' progress. Tasks
        # hold consecutive rids, so each ships as (first rid +
        # bounds/activity arrays) — nothing object-shaped crosses
        # the pipe and the owner rebuilds the regions locally.
        regions = self.regions
        for w in range(self.pool.n):
            while self.wtasks[w] and self.inflight[w] < MAX_INFLIGHT:
                t = self.wtasks[w].popleft()
                rids = self.tasks[t]
                msg = (
                    "prep", self.gen, t, rids[0],
                    np.fromiter((regions[r].start for r in rids),
                                np.int64, len(rids)),
                    np.fromiter((regions[r].end for r in rids),
                                np.int64, len(rids)),
                    np.fromiter((regions[r].is_active for r in rids),
                                np.bool_, len(rids)),
                )
                if trace.enabled():
                    # the send stamp: the worker's span reads its queue wait
                    msg += (time.perf_counter_ns(),)
                self.pool.req_qs[w].put(msg)
                self.inflight[w] += 1

    def note_prep_done(self, wid: int, task_id: int) -> None:
        """Receipt-side flow control (called from the pool's recv path
        the moment a prep_done arrives, even when this run's results are
        only being buffered). The refill stops once too many results sit
        unconsumed — a pre-started span must not buffer a whole contig's
        prepared payloads in the main process."""
        if trace.enabled():
            self.received[task_id] = time.perf_counter_ns()
        self.inflight[wid] -= 1
        self.preps_received += 1
        consumed = len(self.tasks) - self.preps_unconsumed
        if self.preps_received - consumed < PRESTART_BUFFER:
            self.send_tasks()

    def _run_pairhmm(self, batch, workloads, received):
        # off the event loop: torch/numpy release the GIL during the
        # heavy work, so the recv/emit loop keeps draining results
        from ..ops import pairhmm

        with trace.span("pairhmm.batch") as sp:
            pairs = pairhmm.compute_read_likelihoods_multi(
                workloads, use_device=self.use_device_pairhmm)
            if sp:
                sp.set(regions=len(batch),
                       pairs=sum(len(r) * len(h) for r, h, _ in workloads),
                       cells=sum(sum(len(x[0]) for x in r) * sum(len(x) for x in h)
                                 for r, h, _ in workloads))
                dev = sp.child("pairhmm.device")
                if dev is not None and received:
                    # each region's wait from its prep result's receipt
                    # to the batch's device start
                    waits = [dev.start - t for t in received]
                    sp.set(bytes=dev.attrs.get("bytes", 0), wait_sum_ns=sum(waits),
                           wait_max_ns=max(waits))
            with trace.span("pairhmm.send"):
                for rid, (vals, keep) in zip(batch, pairs):
                    self.pool.req_qs[self.owner[rid]].put(
                        ("geno", self.gen, rid, vals, keep))

    def _batch_pairs(self) -> int:
        return sum(len(self.pend_inputs[rid][0]) * len(self.pend_inputs[rid][1])
                   for rid in self.pending_batch)

    def dispatch_pairhmm(self, force=False) -> None:
        if not self.pending_batch:
            return
        if not force and self._batch_pairs() < PAIRHMM_PAIR_TARGET \
                and len(self.pending_batch) < PAIRHMM_MAX_PENDINGS:
            return
        batch = self.pending_batch[:]
        del self.pending_batch[:]
        workloads = [self.pend_inputs.pop(rid) for rid in batch]
        received = [self.pend_received.pop(rid) for rid in batch
                    if rid in self.pend_received]
        self.ph_futures.append(self.ph_pool.submit(self._run_pairhmm, batch,
                                                   workloads, received))

    def check_pairhmm_errors(self) -> None:
        # a failed dispatch would otherwise hang the pipeline: its
        # geno messages never arrive. Surface the exception here.
        for f in list(self.ph_futures):
            if f.done():
                exc = f.exception()
                if exc is not None:
                    raise exc
                self.ph_futures.remove(f)

    def results(self, deletions, health=None):
        """Yield (region, variants, deletions) in region order; drops
        the span when exhausted. ``health`` (optional zero-arg callable
        that raises) is polled alongside the PairHMM error check so a
        downstream-sink failure surfaces here instead of after more
        dispatch work."""
        from concurrent.futures import ThreadPoolExecutor

        pool, gen, n = self.pool, self.gen, self.n
        regions = self.regions
        term, geno = self.term, self.geno
        redo_sent = self.redo_sent
        self.ph_pool = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="pairhmm-dispatch")
        emit = 0
        try:
            while emit < n:
                progressed = True
                while progressed:
                    progressed = False
                    # advance the ordered consumer as far as possible
                    while emit < n:
                        if emit in term:
                            yield regions[emit], term.pop(emit), deletions
                            emit += 1
                            progressed = True
                            continue
                        if emit in geno:
                            variants, outgoing, consulted = geno.pop(emit)
                            if emit in redo_sent or not deletions:
                                # a redo, or speculation, ran under the
                                # true carry
                                redo_sent.discard(emit)
                                deletions = outgoing
                            elif consulted:
                                # speculation read an empty carry where
                                # the true one is not: rerun with it
                                redo_sent.add(emit)
                                pool.req_qs[self.owner[emit]].put(
                                    ("redo", gen, emit, deletions))
                                break
                            else:
                                # never read: the true carry only
                                # precedes what the region appended
                                trace.count("hc.carry_kept")
                                deletions = deletions + outgoing
                            yield regions[emit], variants, deletions
                            emit += 1
                            progressed = True
                            continue
                        break
                if emit >= n:
                    break
                self.check_pairhmm_errors()
                if health is not None:
                    health()

                def _chk():
                    self.check_pairhmm_errors()
                    if health is not None:
                        health()

                msg = pool._recv_routed(("prep_done", "geno_done"), gen,
                                        extra_check=_chk)
                if msg[0] == "prep_done":
                    # flow control already ran at receipt (note_prep_done);
                    # the force condition tracks CONSUMPTION so the final
                    # PairHMM batch is not split across the buffered tail
                    _, _, wid, task_id, out = msg
                    self.preps_unconsumed -= 1
                    self.send_tasks()  # receipt-side refill may be capped
                    t_recv = self.received.pop(task_id, None)
                    for item in out:
                        rid = item[0]
                        if item[1] == "term":
                            term[rid] = item[2]
                        else:
                            self.pend_inputs[rid] = (item[2], item[3], item[4])
                            self.pending_batch.append(rid)
                            if t_recv is not None:
                                self.pend_received[rid] = t_recv
                    self.dispatch_pairhmm(force=self.preps_unconsumed == 0)
                elif msg[0] == "geno_done":
                    geno[msg[2]] = msg[3:]
            self.check_pairhmm_errors()
        finally:
            if self.ph_pool is not None:
                self.ph_pool.shutdown(wait=True)
        pool.drop_span(gen)
        return


_pool: Optional[HCWorkerPool] = None
_pool_size = 0


def get_pool(n_workers: int) -> Optional[HCWorkerPool]:
    """Shared pool, reused across call_variants invocations (sfm runs
    one per shard; spawn startup is worth amortizing)."""
    global _pool, _pool_size
    if n_workers <= 1:
        return None
    if _pool is not None and _pool_size == n_workers:
        return _pool
    if _pool is not None:
        _pool.close()
        _pool = None
    try:
        _pool = HCWorkerPool(n_workers)
        import atexit

        atexit.register(shutdown_pool)
    except Exception as e:
        if mp.parent_process() is not None:
            # we are inside a spawn child re-importing an unguarded
            # caller script: crash the child so the parent fails fast
            # instead of this child silently re-running the pipeline
            raise
        # parent-side spawn failure: degrade to single-process rather
        # than crashing the pipeline.
        import sys

        print(f"elprep_tpu_torch: worker pool unavailable ({e}); "
              "running single-process", file=sys.stderr)
        _pool = None
        _pool_size = 0
        return None
    _pool_size = n_workers
    return _pool


def shutdown_pool() -> None:
    global _pool, _pool_size
    if _pool is not None:
        _pool.close()
        _pool = None
        _pool_size = 0
