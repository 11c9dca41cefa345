"""Entry points of the port: the counterpart of the JAX package's root
``__graft_entry__.py``, function for function.

``fused_device_step`` is the fused single-device step of the 5-step
pipeline (coordinate-sort permutation, duplicate marking, the BQSR table
build and ApplyBQSR) that ``bench.py`` times; ``entry()`` returns
``(fn, example_args)`` for the sort + dedup + tables step;
``dryrun_multichip(n)`` runs the sharded programs over a mesh of ``n``
entries of the session device, then ``filter --sharded`` against the
whole-file run and two gloo processes against it.

Where the JAX package jits a step into one XLA executable, the port
captures it on ``cuda`` into one CUDA graph per argument shape
(:class:`_GraphedStep`) and replays it; on the CPU the same composition
runs eagerly. Every function takes ``device=`` (``None``: the session
default, ``cuda``).
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from . import device as _device
from .core.batch import DUPLICATE


def _synthetic_columns(n_reads: int, read_len: int, ref_len: int, seed: int = 0):
    """Tiny synthetic padded read columns matching ops.bqsr_ops inputs
    (the JAX package's generator, draw for draw)."""
    from .ops.readstats import OP_CLASS

    rng = np.random.RandomState(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n_reads, read_len)).astype(np.uint8)
    qual = rng.randint(2, 40, size=(n_reads, read_len)).astype(np.uint8)
    seq_len = np.full(n_reads, read_len, np.int32)
    flag = np.where(rng.rand(n_reads) < 0.5, 0x63, 0x93).astype(np.int32)  # proper pairs
    pos = rng.randint(1, ref_len - read_len - 1, size=n_reads).astype(np.int32)
    rg = np.zeros(n_reads, np.int32)
    refoff = np.zeros(n_reads, np.int32)
    skip = np.zeros((n_reads, read_len), bool)
    # single M op covering the read
    op_class = np.full((n_reads, 1), OP_CLASS[ord("M")], np.int32)
    op_len = np.full((n_reads, 1), read_len, np.int32)
    ref_classes = rng.randint(1, 5, size=ref_len).astype(np.uint8)
    return base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len, ref_classes


def _leaves(out):
    """Array leaves of nested tuples, lists and dicts (dict keys sorted),
    in the order of ``jax.tree_util.tree_leaves``."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def sync_scalar(out) -> float:
    """The first element of every non-empty tensor (or array) leaf of
    ``out``, summed in float32 in leaf order, as a float. Its ``.item()``
    waits for the device: what bench.py's timing synchronizes on."""
    acc = None
    for leaf in _leaves(out):
        if not hasattr(leaf, "reshape") or not np.prod(np.shape(leaf)):
            continue
        v = torch.as_tensor(leaf).reshape(-1)[0].to(torch.float32)
        acc = v if acc is None else acc + v.to(acc.device)
    return float(acc.item()) if acc is not None else 0.0


# ---------------------------------------------------------------------------
# One program per step: a CUDA graph on cuda, eager on the CPU
# ---------------------------------------------------------------------------


def _on(dev: torch.device, a) -> torch.Tensor:
    return torch.as_tensor(a).to(dev)


class _GraphedStep:
    """``fn`` over tensors on one card as CUDA graphs, the counterpart of
    ``jax.jit``: the first call for a list of argument shapes and dtypes
    warms ``fn`` up on a side stream, then captures it whole into one
    ``torch.cuda.CUDAGraph``; every call copies its arguments into that
    graph's static inputs, replays it and returns clones of its static
    outputs, so one call's results are never overwritten by the next. A
    capture that fails raises: nothing runs ``fn`` eagerly instead."""

    WARMUP = 3

    def __init__(self, fn, dev: torch.device):
        self.fn = fn
        self.dev = dev if dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        self.graphs = {}
        self.lock = threading.Lock()

    def _capture(self, args):
        static_in = [a.to(self.dev).clone() for a in args]
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self.fn(*static_in)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.dev), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            static_out = self.fn(*static_in)
        return graph, static_in, static_out

    def __call__(self, *args):
        args = [torch.as_tensor(a) for a in args]
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        with self.lock:
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(args)
            graph, static_in, static_out = entry
            with torch.cuda.device(self.dev):
                for s, a in zip(static_in, args):
                    s.copy_(a)
                graph.replay()
                return tuple(o.clone() for o in static_out)


def _eager(fn, dev: torch.device):
    """``fn`` over its arguments moved to ``dev``, run op by op."""
    def run(*args):
        return fn(*(_on(dev, a) for a in args))

    return run


def _program(fn, dev: torch.device):
    """The step as callers get it: one graph per shape on cuda, eager on
    the CPU."""
    return _GraphedStep(fn, dev) if dev.type == "cuda" else _eager(fn, dev)


# ---------------------------------------------------------------------------
# The fused single-device step
# ---------------------------------------------------------------------------


def _step_body(n_rg: int, max_cycle: int, dev: torch.device):
    """The step's composition over tensors on ``dev``
    (``__graft_entry__.py:72-89``), its constant tables built once there."""
    from .ops import sortkeys
    from .ops.bqsr_ops import apply_bqsr, recalibrate_tables
    from .ops.dedup import mark_duplicates

    cond_prior = torch.full((n_rg, 94), 30, dtype=torch.int32, device=dev)
    d_cyc = torch.zeros((n_rg, 94, 2 * max_cycle + 1), dtype=torch.int32, device=dev)
    d_ctx = torch.zeros((n_rg, 94, 17), dtype=torch.int32, device=dev)
    quant_lut = torch.arange(94, dtype=torch.uint8, device=dev)
    sqq_lut = torch.arange(255, dtype=torch.uint8, device=dev)
    rg_present = torch.ones(n_rg, dtype=torch.bool, device=dev)

    def step(base, qual, seq_len, flag, pos, libid, refid, qrank, rg, refoff,
             skip, op_class, op_len, ref_classes):
        perm = sortkeys.coordinate_sort_perm(
            flag, refid, pos, torch.full_like(pos, 60), refid, pos,
            torch.zeros_like(pos), qrank, device=dev)
        rev = (flag >> 4) & 1
        score = torch.where(qual >= 15, qual.to(torch.int32), 0).sum(dim=1)
        dup = mark_duplicates(libid, refid, pos, rev, score, qrank, flag, device=dev)
        tabs = recalibrate_tables(
            base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
            ref_classes, max_cycle=max_cycle, n_rg=n_rg, device=dev)
        newq, _ = apply_bqsr(
            base, qual, seq_len, flag, rg, rg_present, cond_prior, d_cyc, d_ctx,
            quant_lut, sqq_lut, max_cycle=max_cycle, device=dev)
        return perm, dup, newq, tabs[0]

    return step


def _packed_body(n_rg: int, max_cycle: int, width: int, dev: torch.device):
    """The step fed packed base and skip columns, unpacked on ``dev``."""
    from .ops.packed import unpack_bits, unpack_nibble_dict

    inner = _step_body(n_rg, max_cycle, dev)

    def step(base_p, lut, qual, seq_len, flag, pos, libid, refid, qrank, rg,
             refoff, skip_p, op_class, op_len, ref_classes):
        base = unpack_nibble_dict(base_p, lut, width)
        skip = unpack_bits(skip_p, width)
        return inner(base, qual, seq_len, flag, pos, libid, refid, qrank, rg,
                     refoff, skip, op_class, op_len, ref_classes)

    return step


def fused_device_step(n_rg: int = 1, max_cycle: int = 512, device=None):
    """The fused single-device step of the 5-step pipeline (coordinate-sort
    perm + duplicate marking + BQSR table build + ApplyBQSR) as ONE
    program: a callable over the 14 columns of :func:`fused_step_columns`
    (numpy arrays or tensors) giving ``(perm, dup, newq, qs_obs)`` as
    tensors on ``device``. On ``cuda`` each argument shape is captured
    once into a CUDA graph and replayed; on the CPU it runs eagerly."""
    dev = _device.resolve(device)
    return _program(_step_body(n_rg, max_cycle, dev), dev)


def fused_device_step_eager(n_rg: int = 1, max_cycle: int = 512, device=None):
    """The plain version of :func:`fused_device_step`: the same ops run
    one by one on ``device``, never captured."""
    dev = _device.resolve(device)
    return _eager(_step_body(n_rg, max_cycle, dev), dev)


def fused_device_step_packed(n_rg: int = 1, max_cycle: int = 512,
                             width: int = 128, device=None):
    """:func:`fused_device_step` fed PACKED base/skip columns
    (ops/packed): the 4-bit-dictionary bases and the bit-packed skip mask
    unpack on the device inside the step's own graph, so the dense
    [n, width] matrices never cross the host->device link. The same
    outputs, bit for bit."""
    dev = _device.resolve(device)
    return _program(_packed_body(n_rg, max_cycle, width, dev), dev)


def pack_step_columns(cols):
    """Convert :func:`fused_step_columns` output to the argument list of
    :func:`fused_device_step_packed`. Returns None when the base
    alphabet exceeds the 16-symbol dictionary."""
    from .ops.packed import pack_bits, pack_nibble_dict

    (base, qual, seq_len, flag, pos, libid, refid, qrank, rg, refoff,
     skip, op_class, op_len, ref_classes) = cols
    packed = pack_nibble_dict(base)
    if packed is None:
        return None
    bp, lut = packed
    return [bp, lut, qual, seq_len, flag, pos, libid, refid, qrank, rg,
            refoff, pack_bits(skip), op_class, op_len, ref_classes]


def fused_step_columns(n_reads: int, read_len: int = 128,
                       ref_len: int = 1 << 20):
    """Synthetic input columns for :func:`fused_device_step`, in its
    argument order (numpy arrays)."""
    (base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
     ref_classes) = _synthetic_columns(n_reads, read_len, ref_len)
    libid = np.zeros(n_reads, np.int32)
    refid = np.zeros(n_reads, np.int32)
    qrank = np.arange(n_reads, dtype=np.int32)
    return [base, qual, seq_len, flag, pos, libid, refid, qrank, rg, refoff,
            skip, op_class, op_len, ref_classes]


def entry(device=None):
    """(fn, example_args): the fused single-device step of the 5-step
    pipeline -- duplicate marking, the coordinate-sort permutation of the
    flagged reads and the BQSR covariate tables -- as one program (one
    CUDA graph on ``cuda``), with 256 reads x 128 bases over a 4096-base
    reference as its example arguments, on ``device``."""
    from .ops import sortkeys
    from .ops.bqsr_ops import recalibrate_tables
    from .ops.dedup import mark_duplicates

    dev = _device.resolve(device)
    max_cycle, n_rg = 512, 1
    n_reads = 256
    cols = _synthetic_columns(n_reads=n_reads, read_len=128, ref_len=4096)
    libid = np.zeros(n_reads, np.int32)
    refid = np.zeros(n_reads, np.int32)
    qrank = np.arange(n_reads, dtype=np.int32)
    example_args = tuple(_on(dev, c) for c in cols + (libid, refid, qrank))

    def fn(base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
           ref_classes, libid, refid, qrank):
        rev = (flag >> 4) & 1
        score = torch.where(qual >= 15, qual.to(torch.int32), 0).sum(dim=1)
        dup = mark_duplicates(libid, refid, pos, rev, score, qrank, flag, device=dev)
        flag2 = flag | dup.to(flag.dtype) * DUPLICATE
        perm = sortkeys.coordinate_sort_perm(
            flag2, refid, pos, torch.full_like(pos, 60), refid, pos,
            torch.zeros_like(pos), qrank, device=dev)
        tabs = recalibrate_tables(
            base, qual, seq_len, flag, pos, rg, refoff, skip, op_class, op_len,
            ref_classes, max_cycle=max_cycle, n_rg=n_rg, device=dev)
        return perm, dup, tabs[0]

    return _program(fn, dev), example_args


# ---------------------------------------------------------------------------
# Multi-device dryruns
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _session_device(dev: torch.device):
    """For a block: the session device ``dev`` (what the CLI reads from
    ``ELPREP_TPU_TORCH_DEVICE``) and a pool of two HaplotypeCaller
    workers; the environment and the session default come back after."""
    env = {_device.ENV_VAR: str(dev), "ELPREP_TPU_HC_WORKERS": "2"}
    old_env = {k: os.environ.get(k) for k in env}
    old_default = _device._DEFAULT[0]
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _device._DEFAULT[0] = old_default


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the multi-device pipeline over a mesh of ``n_devices`` entries
    of ``device`` (``None``: the session default) on tiny shapes, then on
    real reads: the shipped sharded sort+dedup step (what ``filter
    --sharded`` runs, parallel/sharded.py) against the host twins shard
    by shard; the PairHMM split over every mesh entry (the hand kernel on
    ``cuda``); ``filter --sharded`` against the whole-file run
    (:func:`_dryrun_real_reads`); and two gloo processes of four mesh
    entries each against a whole-file run (:func:`dryrun_multihost`).
    The mesh size is set with ``parallel.mesh.set_local_devices`` and put
    back afterwards."""
    from .ops import sortkeys
    from .ops.dedup import mark_duplicates_host
    from .parallel import mesh as pmesh
    from .parallel import pairhmm_sharded
    from .parallel.sharded import sharded_sort_dedup_step

    dev = _device.resolve(device)
    prev = pmesh._LOCAL_DEVICES[0]
    pmesh.set_local_devices(n_devices)
    try:
        mesh = pmesh.make_mesh(device=dev)
        assert mesh == (dev,) * n_devices, mesh

        # the shipped sort+dedup program on 16 rows per shard
        n_reads = 16 * n_devices
        rng = np.random.RandomState(0)
        flag = np.where(rng.rand(n_reads) < 0.5, 0x63, 0x93).astype(np.int32)
        refid = np.zeros(n_reads, np.int32)
        pos = rng.randint(1, 10_000, n_reads).astype(np.int32)
        mapq = np.full(n_reads, 60, np.int32)
        qrank = np.arange(n_reads, dtype=np.int32)
        zero = np.zeros(n_reads, np.int32)
        rev = (flag >> 4) & 1
        score = rng.randint(0, 3000, n_reads).astype(np.int32)
        cols = (flag, refid, pos, mapq, refid, pos, zero, qrank, zero, pos, rev, score)
        dups, perms = sharded_sort_dedup_step(mesh, *cols)
        assert len(dups) == len(perms) == n_devices
        for s, (dup, perm) in enumerate(zip(dups, perms)):
            rows = slice(16 * s, 16 * (s + 1))
            want = mark_duplicates_host(zero[rows], refid[rows], pos[rows], rev[rows],
                                        score[rows], qrank[rows], flag[rows])
            assert np.array_equal(dup.cpu().numpy(), want), f"shard {s}: dup mask"
            want_perm = sortkeys.coordinate_sort_perm_host(
                flag[rows] | want * DUPLICATE, refid[rows], pos[rows], mapq[rows],
                refid[rows], pos[rows], zero[rows], qrank[rows])
            assert np.array_equal(perm.cpu().numpy(), want_perm), f"shard {s}: sort"

        # the PairHMM over every mesh entry
        rng = np.random.RandomState(0)
        bases4 = np.frombuffer(b"ACGT", np.uint8)
        reads = [(rng.choice(bases4, 32).tobytes(),
                  rng.randint(10, 40, 32).astype(np.uint8), 60)
                 for _ in range(2 * n_devices)]
        haps = [rng.choice(bases4, 48).tobytes() for _ in range(4)]
        vals = pairhmm_sharded(mesh, reads, haps)
        assert vals.shape == (len(reads), len(haps)) and np.isfinite(vals).all()
    finally:
        pmesh.set_local_devices(prev)
    _dryrun_real_reads(n_devices, dev)
    dryrun_multihost()


def _dryrun_sam(seed: int, contigs, n_pairs: int, dup_mate_contig: str,
                dup_mate_pos: int, n_dups: int) -> tuple:
    """Read pairs of 80 bp, 160 bp apart, over random contigs, and
    ``n_dups`` cross-contig duplicate pairs (the JAX dryruns' SAM)."""
    import random

    rng = random.Random(seed)
    genome = {n: "".join(rng.choice("ACGT") for _ in range(ln)) for n, ln in contigs}
    header = ["@HD\tSO:unknown\tVN:1.6"]
    header += [f"@SQ\tLN:{ln}\tSN:{n}" for n, ln in contigs]
    header.append("@RG\tID:rg1\tLB:lib1\tPU:u1\tSM:s1")
    lines = []
    qual = "I" * 80
    for i in range(n_pairs):
        cname, clen = contigs[i % len(contigs)]
        p1 = rng.randrange(1, clen - 400)
        p2 = p1 + 160
        q = f"r{i:05d}"
        s1 = genome[cname][p1 - 1 : p1 + 79]
        s2 = genome[cname][p2 - 1 : p2 + 79]
        tl = p2 - p1 + 80
        lines.append(f"{q}\t99\t{cname}\t{p1}\t60\t80M\t=\t{p2}\t{tl}\t{s1}\t{qual}\tRG:Z:rg1")
        lines.append(f"{q}\t147\t{cname}\t{p2}\t60\t80M\t=\t{p1}\t{-tl}\t{s2}\t{qual}\tRG:Z:rg1")
    for k in range(n_dups):
        q = f"x{k}"
        s = genome["chrA"][999:1079]
        lines.append(f"{q}\t97\tchrA\t1000\t60\t80M\t{dup_mate_contig}\t{dup_mate_pos}\t0"
                     f"\t{s}\t{qual}\tRG:Z:rg1")
        s2 = genome[dup_mate_contig][dup_mate_pos - 1 : dup_mate_pos + 79]
        lines.append(f"{q}\t145\t{dup_mate_contig}\t{dup_mate_pos}\t60\t80M\tchrA\t1000\t0"
                     f"\t{s2}\t{qual}\tRG:Z:rg1")
    sam = ("\n".join(header + lines) + "\n").encode()
    fasta = "".join(">%s\n%s\n" % (n, genome[n]) for n, _ in contigs)
    return sam, fasta


def _filter_args(sam_in: str, out_dir: str, elfasta: str, extra=()) -> list:
    return ["filter", sam_in, os.path.join(out_dir, "out.sam"),
            "--mark-duplicates", "--sorting-order", "coordinate",
            "--bqsr", os.path.join(out_dir, "out.recal"),
            "--haplotypecaller", os.path.join(out_dir, "out.vcf.gz"),
            "--reference-confidence", "GVCF",
            "--reference", elfasta] + list(extra)


def _sam_body(path: str) -> list:
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if not ln.startswith(b"@PG")]


def _vcf_records(path: str) -> list:
    import gzip

    with gzip.open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if not ln.startswith(b"##")]


def _same_outputs(what: str, got: str, want: str) -> None:
    """``got``'s out.sam, out.recal and out.vcf.gz equal ``want``'s (the
    SAM without @PG lines, the VCF without ## lines)."""
    assert _sam_body(os.path.join(got, "out.sam")) == \
        _sam_body(os.path.join(want, "out.sam")), f"{what} SAM != whole-file SAM"
    with open(os.path.join(got, "out.recal")) as a, \
            open(os.path.join(want, "out.recal")) as b:
        assert a.read() == b.read(), f"{what} recal != whole-file recal"
    assert _vcf_records(os.path.join(got, "out.vcf.gz")) == \
        _vcf_records(os.path.join(want, "out.vcf.gz")), f"{what} VCF != whole-file VCF"


def _dryrun_real_reads(n_devices: int, device=None) -> None:
    """The integrated multi-device path on REAL parsed reads: a generated
    SAM through ``filter --sharded`` (per-shard sort+dedup, BQSR tables
    summed over the shards, the HaplotypeCaller's PairHMM batches split
    over the mesh of ``n_devices`` entries of ``device``) and
    byte-compared against the single-device run, both on a pool of two
    HaplotypeCaller workers."""
    import tempfile

    from . import cli
    from .parallel import mesh as pmesh

    dev = _device.resolve(device)
    sam, fasta = _dryrun_sam(42, [("chrA", 6000), ("chrB", 5000)], 150,
                             "chrB", 2000, 4)
    prev = pmesh._LOCAL_DEVICES[0]
    pmesh.set_local_devices(n_devices)
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun_mc_") as wd, _session_device(dev):
            sam_in = os.path.join(wd, "in.sam")
            with open(sam_in, "wb") as f:
                f.write(sam)
            with open(os.path.join(wd, "ref.fasta"), "w") as f:
                f.write(fasta)
            elfasta = os.path.join(wd, "ref.elfasta")
            assert cli.main(["fasta-to-elfasta", os.path.join(wd, "ref.fasta"),
                             elfasta]) == 0
            outs = {}
            for tag, extra in (("sharded", ["--sharded"]), ("plain", [])):
                outs[tag] = os.path.join(wd, tag)
                os.makedirs(outs[tag])
                rc = cli.main(_filter_args(sam_in, outs[tag], elfasta, extra))
                assert rc == 0, f"{tag} pipeline failed"
            _same_outputs("sharded", outs["sharded"], outs["plain"])
    finally:
        pmesh.set_local_devices(prev)


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 4) -> None:
    """Multi-process dryrun: ``n_processes`` ranks of ``python -m
    elprep_tpu_torch.parallel.multihost`` on gloo (the CPU), each with a
    mesh of ``devices_per_process`` entries, run the FULL 5-step -- the
    sharded sort+dedup+BQSR with cross-process collectives (all-gathered
    verdicts, all-reduced tables) and the contig-partitioned GVCF
    HaplotypeCaller with its shard VCFs gathered in order. Every
    process's output must byte-equal a whole-file run in one process
    (the reference's multi-node contract, README.md:679-682)."""
    import socket
    import subprocess
    import sys
    import tempfile

    from . import cli

    contigs = [("chrA", 6000), ("chrB", 5000), ("chrC", 4000), ("chrD", 4000)]
    sam, fasta = _dryrun_sam(7, contigs, 200, "chrD", 2000, 6)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env[_device.ENV_VAR] = "cpu"
    env["ELPREP_TPU_HC_WORKERS"] = "2"

    with tempfile.TemporaryDirectory(prefix="dryrun_mh_") as wd:
        sam_in = os.path.join(wd, "in.sam")
        with open(sam_in, "wb") as f:
            f.write(sam)
        with open(os.path.join(wd, "ref.fasta"), "w") as f:
            f.write(fasta)
        elfasta = os.path.join(wd, "ref.elfasta")
        assert cli.main(["fasta-to-elfasta", os.path.join(wd, "ref.fasta"),
                         elfasta]) == 0

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        # the shard-VCF exchange directory all ranks share (each writes its
        # final output to its own directory, so the outputs byte-compare)
        shard_dir = os.path.join(wd, "hc_shards")
        os.makedirs(shard_dir)
        plain = os.path.join(wd, "plain")
        os.makedirs(plain)
        # the whole-file run, a process of its own, beside the ranks
        cmds = [[sys.executable, "-m", "elprep_tpu_torch"]
                + _filter_args(sam_in, plain, elfasta)]
        outs = []
        for pid in range(n_processes):
            outs.append(os.path.join(wd, f"host{pid}"))
            os.makedirs(outs[-1])
            cmds.append([sys.executable, "-m", "elprep_tpu_torch.parallel.multihost",
                         "--coordinator", f"127.0.0.1:{port}",
                         "--num-processes", str(n_processes), "--process-id", str(pid),
                         "--local-devices", str(devices_per_process), "--"]
                        + _filter_args(sam_in, outs[-1], elfasta, ["--sharded"]))
        procs = [subprocess.Popen(c, env=env if k == 0 else dict(
            env, ELPREP_TPU_HC_SHARD_DIR=shard_dir)) for k, c in enumerate(cmds)]
        try:
            for k, pr in enumerate(procs):
                rc = pr.wait(timeout=600)
                assert rc == 0, f"dryrun process {k} failed: rc {rc}"
        finally:
            # a failed rank leaves its peers blocked in a collective
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()

        assert len(_vcf_records(os.path.join(plain, "out.vcf.gz"))) > 10, \
            "whole-file GVCF unexpectedly empty"
        for out in outs:
            _same_outputs("multihost", out, plain)
        assert not [f for f in os.listdir(shard_dir) if f.endswith(".part")], \
            "multihost shard VCFs not cleaned up"
