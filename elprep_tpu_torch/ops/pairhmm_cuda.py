"""PairHMM forward pass on the card: the hand-written Hopper kernels
(``csrc/pairhmm.cu``), their wrapper, their plain PyTorch version and the
launch counters.

This is the counterpart of ``elprep_tpu/ops/pairhmm_pallas.py``: the
kernels replace the Pallas TPU wavefront ``pairhmm_pallas._kernel``. Two
kernels compute the same function, bit for bit; ``launch_plan`` picks one
per batch from its longest read: the warp-per-pair kernel ("warp") up to
``WARP_MAX_READ_LEN`` bases, the CTA-per-pair kernel ("cta") above.

Inputs travel as one :class:`PairBatch`: the distinct reads and
haplotypes of a dispatch, each stored once (bases, modified qualities and
tandem-repeat lengths as uint8, offsets and lengths as int32, the
haplotype's ``2^100 / lh`` start value as float32), plus the (read, hap)
index of every pair. All of it sits in one uint8 buffer, so a dispatch
costs one host-to-device copy; the f32 probabilities are looked up on the
device from :class:`PairHMMTables`.

``pairhmm_forward`` takes the plain version only for a batch on the
CPU. For a batch on ``cuda`` it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..hc import tables
from .pairhmm import (F32_INITIAL_POW, F32_RESCUE_LOG10, modified_qualities,
                      pairhmm_f64_diag, repeat_lengths_for_read)

# kernel launches so far, in all and per path (the wrapper adds one where
# it launches a kernel, nowhere else)
LAUNCHES = 0
LAUNCHES_BY_PATH = {"warp": 0, "cta": 0}

# The HaplotypeCaller pool may dispatch from several threads at once
# (ELPREP_TPU_PAIRHMM_DISPATCH_WORKERS > 1). This lock covers the three
# check-then-act steps they share: the library build,
# the per-device tables and the launch counts. The launches themselves
# need no more: both threads use the current (default) stream, and each
# caller ends in ``.cpu()``, which waits for its own kernel.
_LOCK = threading.Lock()

I2M = np.float32(tables.INDEL_TO_MATCH)
I2I = np.float32(tables.INDEL_TO_INDEL)
_N = ord("N")

# the CTA kernel's launch shape: at most this many threads (a multiple of
# 32) per pair, each holding 1, 2, 4, ... rows of the DP matrix
MAX_THREADS = 256
MAX_ROWS_PER_THREAD = 64
MAX_READ_LEN = MAX_THREADS * MAX_ROWS_PER_THREAD
# the warp kernel's: one warp per pair, each lane holding 1, 2, 3, ... 8
# rows; WARPS_PER_CTA pairs per CTA. 4 rather than 8: with no barrier the
# warps of a CTA share nothing, and at 5 rows per lane the register file
# holds more warps per SM as CTAs of 4 than of 8 (4 was the faster in every
# run that timed both on the same pairs, PERF.md)
WARP_MAX_ROWS = 8
WARP_MAX_READ_LEN = 32 * WARP_MAX_ROWS
WARPS_PER_CTA = 4

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "pairhmm.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PairHMMTables:
    """float32 lookup tables on one device, each with a trailing
    exact-zero sentinel entry: mp / nmp by modified quality, m2m / m2i by
    tandem-repeat length."""

    mp: torch.Tensor
    nmp: torch.Tensor
    m2m: torch.Tensor
    m2i: torch.Tensor


def _table_arrays() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The four tables, computed in f64 and cast once to f32, sentinel
    appended (elprep_tpu/ops/pairhmm_pallas.py:144-147)."""
    return (np.append(1.0 - tables.QUAL_TO_ERROR_PROB, 0.0).astype(np.float32),
            np.append(tables.QUAL_TO_ERROR_PROB / 3.0, 0.0).astype(np.float32),
            np.append(tables.MATCH_TO_MATCH, 0.0).astype(np.float32),
            np.append(tables.MATCH_TO_INDEL, 0.0).astype(np.float32))


def tables_from_numpy(mp, nmp, m2m, m2i, device="cpu") -> PairHMMTables:
    """Device tables from four numpy arrays (sentinel entry included)."""
    dev = torch.device(device)
    return PairHMMTables(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                            ).to(dev) for a in (mp, nmp, m2m, m2i)))


_TABLES: Dict[torch.device, PairHMMTables] = {}


def default_tables(device) -> PairHMMTables:
    """The package's tables on ``device``, built once per device."""
    dev = torch.device(device)
    with _LOCK:
        if dev not in _TABLES:
            _TABLES[dev] = tables_from_numpy(*_table_arrays(), device=dev)
        return _TABLES[dev]


# ---------------------------------------------------------------------------
# Packed inputs
# ---------------------------------------------------------------------------

_FIELDS = (
    ("read_bases", np.uint8), ("read_quals", np.uint8),
    ("read_repeats", np.uint8), ("read_offsets", np.int32),
    ("read_lengths", np.int32), ("hap_bases", np.uint8),
    ("hap_offsets", np.int32), ("hap_lengths", np.int32),
    ("hap_init", np.float32), ("pair_read", np.int32), ("pair_hap", np.int32),
)
_TORCH_DTYPE = {np.uint8: torch.uint8, np.int32: torch.int32,
                np.float32: torch.float32}


class PairBatch:
    """The inputs of one dispatch in one uint8 buffer (fields 16-byte
    aligned), on one device. ``field(name)`` returns a typed view."""

    def __init__(self, blob: torch.Tensor, layout: Dict[str, Tuple[int, int, type]],
                 max_read_len: int, n_pairs: int):
        self.blob = blob
        self.layout = layout
        self.max_read_len = max_read_len
        self.n_pairs = n_pairs

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "PairBatch":
        layout = {}
        off = 0
        for name, dt in _FIELDS:
            n = int(arrays[name].size)
            layout[name] = (off, n, dt)
            off += -(-n * np.dtype(dt).itemsize // 16) * 16
        blob = np.zeros(max(off, 16), np.uint8)
        for name, dt in _FIELDS:
            o, n, _ = layout[name]
            blob[o : o + n * np.dtype(dt).itemsize] = np.ascontiguousarray(
                arrays[name], dt).view(np.uint8)
        lens = arrays["read_lengths"]
        return cls(torch.from_numpy(blob), layout,
                   int(lens.max()) if lens.size else 0,
                   int(arrays["pair_read"].size))

    @property
    def device(self) -> torch.device:
        return self.blob.device

    def field(self, name: str) -> torch.Tensor:
        o, n, dt = self.layout[name]
        size = n * np.dtype(dt).itemsize
        return self.blob[o : o + size].view(_TORCH_DTYPE[dt])

    def to(self, device) -> "PairBatch":
        return PairBatch(self.blob.to(device), self.layout, self.max_read_len,
                         self.n_pairs)


def pack_pairs(reads: Sequence[Tuple[bytes, np.ndarray, int]],
               haps: Sequence[bytes], pair_r, pair_h) -> PairBatch:
    """Host packing (on the CPU): each read and haplotype that a pair
    uses is stored once; per-read work (modified qualities, tandem-repeat
    lengths) runs once per read, not once per pair."""
    pair_r = np.asarray(pair_r, np.int64)
    pair_h = np.asarray(pair_h, np.int64)
    ur, r_idx = np.unique(pair_r, return_inverse=True)
    uh, h_idx = np.unique(pair_h, return_inverse=True)
    seqs = [reads[int(r)][0] for r in ur]
    rlen = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    quals = [modified_qualities(reads[int(r)][1], reads[int(r)][2]) for r in ur]
    rq = np.concatenate(quals) if quals else np.zeros(0, np.int64)
    rrl = (np.concatenate([repeat_lengths_for_read(s) for s in seqs])
           if seqs else np.zeros(0, np.uint8))
    hseqs = [haps[int(h)] for h in uh]
    hlen = np.fromiter((len(h) for h in hseqs), np.int64, len(hseqs))
    if rlen.size and rlen.max() > MAX_READ_LEN:
        raise ValueError(f"PairHMM read of {int(rlen.max())} bases exceeds the "
                         f"kernel's {MAX_READ_LEN}-row limit")
    n_tab = len(tables.QUAL_TO_ERROR_PROB)
    if rq.size and rq.max() >= n_tab:
        raise ValueError(f"modified quality {int(rq.max())} outside the "
                         f"{n_tab}-entry table")
    return PairBatch.from_arrays({
        "read_bases": np.frombuffer(b"".join(seqs), np.uint8),
        "read_quals": rq.astype(np.uint8),
        "read_repeats": rrl.astype(np.uint8),
        "read_offsets": np.concatenate([[0], np.cumsum(rlen)[:-1]]).astype(np.int32),
        "read_lengths": rlen.astype(np.int32),
        "hap_bases": np.frombuffer(b"".join(hseqs), np.uint8),
        "hap_offsets": np.concatenate([[0], np.cumsum(hlen)[:-1]]).astype(np.int32),
        "hap_lengths": hlen.astype(np.int32),
        # f64 division, one f32 rounding (the JAX package's init)
        "hap_init": (2.0 ** F32_INITIAL_POW / hlen.astype(np.float64)).astype(np.float32),
        "pair_read": r_idx.astype(np.int32),
        "pair_hap": h_idx.astype(np.int32),
    })


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _shift1(a: torch.Tensor) -> torch.Tensor:
    """Row i takes row i-1 (row 0 takes zero)."""
    return torch.nn.functional.pad(a[:, :-1], (1, 0))


def pairhmm_forward_plain(batch: PairBatch, tabs: PairHMMTables) -> torch.Tensor:
    """Plain PyTorch version of the kernel: batched [B, n] tensor ops, one
    Python step per anti-diagonal. Operation order as in the kernel:
    M = prior * ((M2*m2m + I2*i2m) + D2*i2m), I = M1u*m2i + I1u*i2i,
    D = M1*m2i + D1*i2i, each op rounded to f32 on its own."""
    dev = batch.device
    pr = batch.field("pair_read").long()
    ph = batch.field("pair_hap").long()
    B = pr.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    lr = batch.field("read_lengths").long()[pr]
    lh = batch.field("hap_lengths").long()[ph]
    roff = batch.field("read_offsets").long()[pr]
    hoff = batch.field("hap_offsets").long()[ph]
    init = batch.field("hap_init")[ph]
    rbases = batch.field("read_bases")
    hbases = batch.field("hap_bases")
    n = batch.max_read_len + 1
    rows = torch.arange(n, device=dev)

    # per-row inputs: row i >= 1 is read base i-1; row 0 and rows past the
    # read take base 0 and the sentinel (zero) table entries
    in_read = (rows[None, :] >= 1) & (rows[None, :] <= lr[:, None])
    src = torch.where(in_read, roff[:, None] + rows[None, :] - 1, 0)
    x = torch.where(in_read, rbases[src], 0)
    q = torch.where(in_read, batch.field("read_quals").long()[src], tabs.mp.shape[0] - 1)
    k = torch.where(in_read, batch.field("read_repeats").long()[src], tabs.m2m.shape[0] - 1)
    mp, nmp = tabs.mp[q], tabs.nmp[q]
    m2m, m2i = tabs.m2m[k], tabs.m2i[k]
    i2m = torch.tensor(I2M, device=dev)
    i2i = torch.tensor(I2I, device=dev)

    zeros = torch.zeros((B, n), dtype=torch.float32, device=dev)
    Md1, Md2, Id1, Id2, Dd2 = zeros, zeros, zeros, zeros, zeros
    Dd1 = zeros.clone()
    Dd1[:, 0] = init  # diagonal 0: D[0, 0] = init
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    bidx = torch.arange(B, device=dev)
    row0 = (rows == 0)[None, :]
    for d in range(1, int((lr + lh).max()) + 1):
        j = d - rows[None, :]
        in_hap = (j >= 1) & (j <= lh[:, None])
        hb = torch.where(in_hap, hbases[torch.where(in_hap, hoff[:, None] + j - 1, 0)], 0)
        is_match = (x == hb) | (x == _N) | (hb == _N)
        prior = torch.where(is_match, mp, nmp)
        M = prior * (_shift1(Md2) * m2m + _shift1(Id2) * i2m + _shift1(Dd2) * i2m)
        I = _shift1(Md1) * m2i + _shift1(Id1) * i2i
        D = Md1 * m2i + Dd1 * i2i
        valid = (j >= 1)
        M = torch.where(valid & ~row0, M, 0.0)
        I = torch.where(valid & ~row0, I, 0.0)
        D = torch.where(row0, init[:, None], torch.where(valid, D, 0.0))
        jf = d - lr
        fin = M[bidx, lr] + I[bidx, lr]
        acc = acc + torch.where((jf >= 1) & (jf <= lh), fin, 0.0)
        Md2, Id2, Dd2 = Md1, Id1, Dd1
        Md1, Id1, Dd1 = M, I, D
    return acc


# ---------------------------------------------------------------------------
# Kernel: build, bind, launch
# ---------------------------------------------------------------------------


class _Library:
    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        lib = ctypes.CDLL(path)
        P = ctypes.c_void_p
        for fn in (lib.pairhmm_forward, lib.pairhmm_forward_warp):
            fn.argtypes = [P] * 15 + [ctypes.c_float, ctypes.c_float, P,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
            fn.restype = ctypes.c_int
        lib.pairhmm_error_string.argtypes = [ctypes.c_int]
        lib.pairhmm_error_string.restype = ctypes.c_char_p
        lib.pairhmm_max_rows_per_thread.restype = ctypes.c_int
        lib.pairhmm_max_threads.restype = ctypes.c_int
        lib.pairhmm_warp_max_rows_per_lane.restype = ctypes.c_int
        if (lib.pairhmm_max_rows_per_thread() != MAX_ROWS_PER_THREAD
                or lib.pairhmm_max_threads() != MAX_THREADS
                or lib.pairhmm_warp_max_rows_per_lane() != WARP_MAX_ROWS):
            raise RuntimeError(f"{path}: launch limits disagree with the wrapper")
        self.lib = lib
        self.entry = {"cta": lib.pairhmm_forward, "warp": lib.pairhmm_forward_warp}


_LIB: list = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the PairHMM "
                       "kernel cannot be built")


def library() -> _Library:
    """Build (once per source hash, into elprep_tpu_torch/_build/) and load
    the kernel library. A build or load failure raises."""
    with _LOCK:
        if not _LIB:
            _LIB.append(_build_library())
        return _LIB[0]


def _build_library() -> _Library:
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libpairhmm_{key}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True, timeout=600)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {_SRC}:\n{log}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _Library(path, time.perf_counter() - t0, log)


def launch_plan(max_read_len: int, path: Optional[str] = None) -> Tuple[str, int, int]:
    """(path, threads, rows per thread) for a batch whose longest read has
    ``max_read_len`` bases. Up to WARP_MAX_READ_LEN bases the "warp" path:
    WARPS_PER_CTA warps per CTA, one pair per warp, at most
    ceil(max_read_len / 32) rows per lane (the kernel's instantiation; each
    warp takes ceil(lr / 32) for its own pair). Above it the "cta" path:
    one CTA per pair, rows per
    thread the smallest power of two that fits the read in MAX_THREADS
    threads. ``path`` forces one of the two for a batch it can take."""
    if max_read_len > MAX_READ_LEN:
        raise ValueError(f"read of {max_read_len} bases exceeds {MAX_READ_LEN}")
    if path is None:
        path = "warp" if max_read_len <= WARP_MAX_READ_LEN else "cta"
    if path == "warp":
        if max_read_len > WARP_MAX_READ_LEN:
            raise ValueError(f"read of {max_read_len} bases exceeds the warp "
                             f"path's {WARP_MAX_READ_LEN}")
        return "warp", 32 * WARPS_PER_CTA, max(1, -(-max_read_len // 32))
    if path != "cta":
        raise ValueError(f"unknown PairHMM path {path!r}")
    rows = 1
    while rows * MAX_THREADS < max_read_len:
        rows *= 2
    per_thread = -(-max_read_len // rows)
    return "cta", max(32, -(-per_thread // 32) * 32), rows


def pairhmm_forward(batch: PairBatch, tabs: PairHMMTables) -> torch.Tensor:
    """acc[b] (float32, on the batch's device): the sum of M + I over the
    last DP row of pair b, scaled by 2^100 / lh. A batch on the CPU runs
    the plain version; a batch on ``cuda`` launches the kernel that
    ``launch_plan`` picks on the current stream (no synchronisation) or
    raises."""
    return _pairhmm_forward_path(batch, tabs, None)


def _pairhmm_forward_path(batch: PairBatch, tabs: PairHMMTables,
                          path: Optional[str]) -> torch.Tensor:
    """pairhmm_forward on a forced ``path`` ("warp" or "cta"; None: the
    plan's). For the tests and chip_smoke.py only."""
    global LAUNCHES
    path, threads, rows = launch_plan(batch.max_read_len, path)
    dev = batch.device
    for name, t in (("mp", tabs.mp), ("nmp", tabs.nmp), ("m2m", tabs.m2m),
                    ("m2i", tabs.m2i)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"table {name}: need contiguous float32 on {dev}")
    if batch.blob.dtype != torch.uint8 or not batch.blob.is_contiguous():
        raise ValueError("pair batch: need one contiguous uint8 buffer")
    if dev.type == "cpu":
        return pairhmm_forward_plain(batch, tabs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc = torch.empty(batch.n_pairs, dtype=torch.float32, device=dev)
    if batch.n_pairs == 0:
        return acc
    lib = library()
    f = batch.field
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.entry[path](
            f("read_bases").data_ptr(), f("read_quals").data_ptr(),
            f("read_repeats").data_ptr(), f("read_offsets").data_ptr(),
            f("read_lengths").data_ptr(), f("hap_bases").data_ptr(),
            f("hap_offsets").data_ptr(), f("hap_lengths").data_ptr(),
            f("hap_init").data_ptr(), f("pair_read").data_ptr(),
            f("pair_hap").data_ptr(), tabs.mp.data_ptr(), tabs.nmp.data_ptr(),
            tabs.m2m.data_ptr(), tabs.m2i.data_ptr(), float(I2M), float(I2I),
            acc.data_ptr(), batch.n_pairs, threads, rows, stream)
    if err != 0:
        raise RuntimeError(f"PairHMM {path} kernel launch failed: "
                           + lib.lib.pairhmm_error_string(err).decode())
    with _LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_PATH[path] += 1
    return acc


def pairhmm_pairs(reads, haps, pair_r, pair_h, device) -> np.ndarray:
    """log10 likelihood per explicit (read, hap) pair on ``device`` (the
    counterpart of pairhmm_pallas_pairs): pack on the host, one copy to
    the device, the kernel (or, for the CPU, its plain version), then the
    f64 host rescue of underflowed pairs."""
    if len(pair_r) == 0:
        return np.zeros(0, np.float64)
    dev = torch.device(device)
    batch = pack_pairs(reads, haps, pair_r, pair_h).to(dev)
    acc = pairhmm_forward(batch, default_tables(dev)).cpu().numpy()
    with np.errstate(divide="ignore"):
        out = np.log10(acc.astype(np.float64)) - F32_INITIAL_POW * np.log10(2.0)
    # f64 rescue for underflow (GATK float->double strategy), on the host
    bad = ~np.isfinite(out) | (out < F32_RESCUE_LOG10)
    for b in np.flatnonzero(bad):
        seq, qual, mapq = reads[int(pair_r[b])]
        out[b] = pairhmm_f64_diag(seq, qual, mapq, haps[int(pair_h[b])])
    return out
