"""PairHMM forward pass on the card: the hand-written Hopper kernels
(``csrc/pairhmm.cu``), their wrapper, their plain PyTorch version and the
launch counters.

This is the counterpart of ``elprep_tpu/ops/pairhmm_pallas.py``: the
kernels replace the Pallas TPU wavefront ``pairhmm_pallas._kernel``. Two
kernels compute the same function, bit for bit; ``launch_plan`` picks one
per batch from its longest read: the warp-per-pair kernel ("warp") up to
``WARP_MAX_READ_LEN`` bases, the warp-per-pair kernel that sweeps a long
read in stripes of rows ("stripe") above.

Inputs travel as one :class:`PairBatch`: the distinct reads and
haplotypes of a dispatch, each stored once (bases, modified qualities and
tandem-repeat lengths as uint8, offsets and lengths as int32, the
haplotype's ``2^100 / lh`` start value as float32), plus the (read, hap)
index of every pair. All of it sits in one uint8 buffer, so a dispatch
costs one host-to-device copy; the f32 probabilities are looked up on the
device from :class:`PairHMMTables`.

``pairhmm_forward`` takes the plain version only for a batch on the
CPU. For a batch on ``cuda`` it launches the kernel or raises.
``pairhmm_pairs`` returns the kernel's float32 sums; the log10 values and
the f64 rescue of underflowed pairs are ``ops/pairhmm.py``'s.
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

from .. import trace
from ..hc import tables
from .pairhmm import F32_INITIAL_POW, modified_qualities, repeat_lengths_for_read

# kernel launches so far, in all and per path (the wrapper adds one where
# it launches a kernel, nowhere else)
LAUNCHES = 0
LAUNCHES_BY_PATH = {"warp": 0, "stripe": 0}

# The wrapper is called from the serial driver's main thread, the
# HaplotypeCaller pool's dispatch thread and the mesh loop, and a process
# may run more than one of them. This lock covers the three check-then-act
# steps they share: the library build, the per-device tables and the launch
# counts. The launches themselves need no more: every caller uses the
# current (default) stream and reads its own result back, which waits for
# its own kernel.
_LOCK = threading.Lock()

I2M = np.float32(tables.INDEL_TO_MATCH)
I2I = np.float32(tables.INDEL_TO_INDEL)
_N = ord("N")

# threads per CTA, at most (the kernels' __launch_bounds__)
MAX_THREADS = 256
# the warp kernel's: one warp per pair, each lane holding 1, 2, 3, ... 8
# rows; WARPS_PER_CTA pairs per CTA. 4 rather than 8: with no barrier the
# warps of a CTA share nothing, and at 5 rows per lane the register file
# holds more warps per SM as CTAs of 4 than of 8 (4 was the faster in every
# run that timed both on the same pairs, PERF.md)
WARP_MAX_ROWS = 8
WARP_MAX_READ_LEN = 32 * WARP_MAX_ROWS
WARPS_PER_CTA = 4
# the stripe kernel's: one warp per pair, a read swept in stripes of rows,
# the first of ceil(lr0 / 32) rows per lane for its first lr0 (1..256)
# rows, each below it 32 * STRIPE_ROWS rows; up to STRIPE_WARPS_PER_CTA
# pairs per CTA, fewer when the longest haplotype needs more shared memory
# than a block may take (the H100's opt-in limit below on the CPU, the
# card's own on cuda)
STRIPE_ROWS = 8
STRIPE_WARPS_PER_CTA = 4
SMEM_PER_BLOCK_H100 = 232448
# the longest read the stripe path takes (and so the package)
MAX_READ_LEN = 16384

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
                 max_read_len: int, n_pairs: int, max_hap_len: int):
        self.blob = blob
        self.layout = layout
        self.max_read_len = max_read_len
        self.n_pairs = n_pairs
        self.max_hap_len = max_hap_len

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
        lens, hlens = arrays["read_lengths"], arrays["hap_lengths"]
        return cls(torch.from_numpy(blob), layout,
                   int(lens.max()) if lens.size else 0,
                   int(arrays["pair_read"].size),
                   int(hlens.max()) if hlens.size else 0)

    @property
    def device(self) -> torch.device:
        return self.blob.device

    def field(self, name: str) -> torch.Tensor:
        o, n, dt = self.layout[name]
        size = n * np.dtype(dt).itemsize
        return self.blob[o : o + size].view(_TORCH_DTYPE[dt])

    def to(self, device) -> "PairBatch":
        return PairBatch(self.blob.to(device), self.layout, self.max_read_len,
                         self.n_pairs, self.max_hap_len)


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
        for fn in (lib.pairhmm_forward_warp, lib.pairhmm_forward_stripe):
            fn.argtypes = [P] * 15 + [ctypes.c_float, ctypes.c_float, P,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
            fn.restype = ctypes.c_int
        lib.pairhmm_error_string.argtypes = [ctypes.c_int]
        lib.pairhmm_error_string.restype = ctypes.c_char_p
        for fn in (lib.pairhmm_stripe_smem_bytes, lib.pairhmm_smem_per_block_optin):
            fn.argtypes = [ctypes.c_int]
        for fn in (lib.pairhmm_max_threads,
                   lib.pairhmm_warp_max_rows_per_lane, lib.pairhmm_stripe_rows_per_lane,
                   lib.pairhmm_stripe_smem_bytes, lib.pairhmm_smem_per_block_optin):
            fn.restype = ctypes.c_int
        if (lib.pairhmm_max_threads() != MAX_THREADS
                or lib.pairhmm_warp_max_rows_per_lane() != WARP_MAX_ROWS
                or lib.pairhmm_stripe_rows_per_lane() != STRIPE_ROWS
                or any(lib.pairhmm_stripe_smem_bytes(lh) != stripe_smem_bytes(lh)
                       for lh in (0, 1, 5, 650, 2400, 16384))):
            raise RuntimeError(f"{path}: launch limits disagree with the wrapper")
        self.lib = lib
        self.entry = {"warp": lib.pairhmm_forward_warp,
                      "stripe": lib.pairhmm_forward_stripe}
        self._smem: Dict[int, int] = {}

    def smem_per_block(self, dev: torch.device) -> int:
        """The most shared memory a block may take on ``dev`` (the opt-in
        limit), asked of the CUDA runtime once per card."""
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in self._smem:
            v = self.lib.pairhmm_smem_per_block_optin(idx)
            if v <= 0:
                raise RuntimeError(f"cannot read the shared memory limit of cuda:{idx}")
            self._smem[idx] = v
        return self._smem[idx]


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
    """The library for this source, built unless a build of it is already
    there; its nvcc log (ptxas's registers and spills) is kept beside it."""
    with open(_SRC, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libpairhmm_{key}.so")
    t0 = time.perf_counter()
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
            with open(tmp + ".log", "w") as fh:
                fh.write(log)
            os.replace(tmp + ".log", path + ".log")
            os.replace(tmp, path)
        finally:
            for f in (tmp, tmp + ".log"):
                if os.path.exists(f):
                    os.remove(f)
    log_path = path + ".log"
    log = open(log_path).read() if os.path.exists(log_path) else ""
    return _Library(path, time.perf_counter() - t0, log)


def stripe_smem_bytes(max_hap_len: int) -> int:
    """Shared memory of one warp on the stripe path for haplotypes of up to
    ``max_hap_len`` bases: the boundary row (M, I, D as float32 for each
    of ``cap`` columns) and the haplotype's bases (``cap`` bytes and room
    for the alignment of their copy), 16-byte aligned; ``cap`` is the
    length rounded up to 4 (csrc/pairhmm.cu: stripe_smem_bytes)."""
    cap = max(4, -(-max_hap_len // 4) * 4)
    return 12 * cap + -(-(cap + 8) // 16) * 16


def stripe_rows(read_len: int) -> Tuple[int, ...]:
    """Rows per lane of each stripe the stripe path sweeps for a read of
    ``read_len`` bases, top first: ceil(lr0 / 32) for the first lr0 =
    read_len - 256 * n rows (1..256), then STRIPE_ROWS for each of the n
    stripes of 256 rows below. A read of up to 256 bases is one stripe, as
    on the warp path."""
    per = 32 * STRIPE_ROWS
    n_full = (read_len - 1) // per if read_len > per else 0
    lr0 = read_len - per * n_full
    return (max(1, -(-lr0 // 32)),) + (STRIPE_ROWS,) * n_full


def launch_plan(max_read_len: int, path: Optional[str] = None, max_hap_len: int = 0,
                smem_per_block: int = SMEM_PER_BLOCK_H100) -> Tuple[str, int, int]:
    """(path, threads, rows per thread) for a batch whose longest read has
    ``max_read_len`` bases and whose longest haplotype ``max_hap_len``. Up
    to WARP_MAX_READ_LEN bases the "warp" path: WARPS_PER_CTA warps per CTA,
    one pair per warp, at most ceil(max_read_len / 32) rows per lane (the
    kernel's instantiation; each warp takes ceil(lr / 32) for its own
    pair). Above it, up to MAX_READ_LEN, the "stripe" path: one pair per
    warp, STRIPE_ROWS rows per lane in a full stripe (``stripe_rows``), as
    many warps per CTA, up to STRIPE_WARPS_PER_CTA, as ``smem_per_block``
    holds at ``stripe_smem_bytes(max_hap_len)`` each; a haplotype that does
    not fit with one warp per CTA raises. ``path`` forces either for a
    batch it can take."""
    if max_read_len > MAX_READ_LEN:
        raise ValueError(f"read of {max_read_len} bases exceeds {MAX_READ_LEN}")
    if path is None:
        path = "warp" if max_read_len <= WARP_MAX_READ_LEN else "stripe"
    if path == "warp":
        if max_read_len > WARP_MAX_READ_LEN:
            raise ValueError(f"read of {max_read_len} bases exceeds the warp "
                             f"path's {WARP_MAX_READ_LEN}")
        return "warp", 32 * WARPS_PER_CTA, max(1, -(-max_read_len // 32))
    if path == "stripe":
        per_warp = stripe_smem_bytes(max_hap_len)
        warps = min(STRIPE_WARPS_PER_CTA, smem_per_block // per_warp)
        if warps < 1:
            raise ValueError(f"PairHMM stripe path: a haplotype of {max_hap_len} bases "
                             f"needs {per_warp} bytes of shared memory per warp, more "
                             f"than the {smem_per_block} a block may take")
        return "stripe", 32 * warps, STRIPE_ROWS
    raise ValueError(f"unknown PairHMM path {path!r}")


def pairhmm_forward(batch: PairBatch, tabs: PairHMMTables) -> torch.Tensor:
    """acc[b] (float32, on the batch's device): the sum of M + I over the
    last DP row of pair b, scaled by 2^100 / lh. A batch on the CPU runs
    the plain version; a batch on ``cuda`` launches the kernel that
    ``launch_plan`` picks on the current stream (no synchronisation) or
    raises."""
    return _pairhmm_forward_path(batch, tabs, None)


def _pairhmm_forward_path(batch: PairBatch, tabs: PairHMMTables,
                          path: Optional[str]) -> torch.Tensor:
    """pairhmm_forward on a forced ``path`` ("warp" or "stripe"; None: the
    plan's). For the tests and chip_smoke.py only."""
    global LAUNCHES
    launch_plan(batch.max_read_len, path)  # a path that cannot take the batch raises
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
    path, threads, rows = launch_plan(batch.max_read_len, path, batch.max_hap_len,
                                      lib.smem_per_block(dev))
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
            acc.data_ptr(), batch.n_pairs, threads,
            batch.max_hap_len if path == "stripe" else rows, stream)
    if err != 0:
        raise RuntimeError(f"PairHMM {path} kernel launch failed: "
                           + lib.lib.pairhmm_error_string(err).decode())
    with _LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_PATH[path] += 1
    return acc


def pairhmm_pairs(reads, haps, pair_r, pair_h, devices) -> np.ndarray:
    """The kernel's float32 sum per explicit (read, hap) pair (what
    pairhmm_forward returns, read back): pack on the host, one copy to the
    device, the kernel (or, for the CPU, its plain version). The pair axis
    splits into one contiguous chunk per entry of ``devices`` (one device,
    or the PairHMM mesh, which may name a device more than once); every
    chunk is packed, then every chunk is launched before any result is read
    back, so chunks on different cards overlap. A pair's value does not
    depend on its batch (padding invariance), so the split is bit-exact.
    Recorder spans (trace.py): ``pairhmm.pack`` and ``pairhmm.device``
    (from the first copy to the device through the last read-back;
    attributes ``bytes`` and ``launches``, the kernels launched)."""
    n = len(pair_r)
    if n == 0:
        return np.zeros(0, np.float32)
    pair_r = np.asarray(pair_r)
    pair_h = np.asarray(pair_h)
    per = -(-n // len(devices))
    chunks = [(torch.device(d), slice(k * per, min(n, (k + 1) * per)))
              for k, d in enumerate(devices) if k * per < n]
    with trace.span("pairhmm.pack"):
        packed = [pack_pairs(reads, haps, pair_r[sl], pair_h[sl]) for _, sl in chunks]
    with trace.span("pairhmm.device") as sp:
        if sp:
            sp.set(bytes=sum(int(b.blob.numel()) for b in packed),
                   launches=sum(dev.type == "cuda" for dev, _ in chunks))
        accs = [pairhmm_forward(b.to(dev), default_tables(dev))
                for (dev, _), b in zip(chunks, packed)]
        return np.concatenate([a.cpu().numpy() for a in accs])
