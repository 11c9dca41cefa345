"""Base quality score recalibration (reference: filters/bqsr.go, 1006 LoC).

Architecture: the per-base covariate computation and table accumulation
run as torch ops on the compute device over dense arrays (ops/bqsr_ops.py;
on the CPU the native engines, as the JAX package's CPU route uses them);
read eligibility and
the adaptor/soft-clip trimming run on host (filters/clipping.py exact
transliterations); the Bayesian finalize runs on host in float64
(vectorized numpy, reference: bqsr.go:553-694).

Tables are dense [nRG, 94(, covariate)] int64 pairs (observations,
mismatches). The ReadGroup covariate is the @RG PU value when present,
else the RG ID (reference: bqsr.go:35-51).
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core.batch import ReadBatch
from ..core.header import Header
from ..io import intervals as iv
from ..io.fasta import RefIndex
from ..ops import bqsr_ops
from ..ops.readstats import pad_cigars
from . import clipping

MAX_QUALITY_SCORE = 93
MAX_RECALIBRATED_QUAL = 93
MAX_REASONABLE_QUAL = 60
MAX_NUMBER_OF_OBSERVATIONS = 2**31 - 2
MIN_INTERESTING_QUAL = 6
NQUAL = bqsr_ops.NQUAL
NCTX = bqsr_ops.NCTX
QUANTIZATION_LEVEL = 16  # for the report (reference: print-bqsr.go:33)
# reads per torch apply on the card: bounds its [rows, width] int64
# intermediates (about 130 MB each at 128 bases) whatever the batch size
APPLY_ROWS = 1 << 17

SECONDARY = 0x100
QC_FAILED = 0x200
DUPLICATE = 0x400

# log10QualEmpiricalPriorCache (reference: bqsr.go:569-591)
_PRIOR_CACHE = np.array(
    [
        -0.045757490560675115, -0.9143464543671788, -3.5201133457866898,
        -7.863058164819208, -13.943180911464733, -21.760481585723266,
        -31.314960187594806, -42.606616717079355, -55.63545117417691,
        -70.40146355888747, -86.90465387121104, -105.14502211114761,
        -125.1225682786972, -146.83729237385978, -170.2891943966354,
        -195.47827434702398, -222.4045322250256, -251.06796803064023,
        -281.46858176386786, -313.60637342472336, -1.7976931348623157e308,
    ],
    dtype=np.float64,
)

_LOG10E = math.log10(math.e)


def _lgamma(x: np.ndarray) -> np.ndarray:
    from scipy.special import gammaln

    return gammaln(x)


def calculate_empirical_quality(
    observations: np.ndarray, mismatches: np.ndarray, prior: np.ndarray
) -> np.ndarray:
    """Vectorized Bayesian argmax (reference: bqsr.go:593-649).

    Inputs already smoothed (+1 mismatch, +2 observations). Returns uint8.
    """
    obs = np.asarray(observations, np.float64)
    mism = np.asarray(mismatches, np.float64)
    over = obs > MAX_NUMBER_OF_OBSERVATIONS
    if over.any():
        # Go math.Round = half away from zero
        scaled = mism[over] * (MAX_NUMBER_OF_OBSERVATIONS / obs[over])
        mism = mism.copy()
        mism[over] = np.floor(scaled + 0.5)
        obs = obs.copy()
        obs[over] = MAX_NUMBER_OF_OBSERVATIONS

    bins = np.arange(MAX_REASONABLE_QUAL + 1, dtype=np.float64)  # [61]
    prior = np.asarray(prior, np.float64)
    diff = np.minimum(
        np.abs(np.trunc(bins[None, :] - prior[..., None])).astype(np.int64),
        len(_PRIOR_CACHE) - 1,
    )
    p1 = _PRIOR_CACHE[diff]

    log10p = bins / -10.0  # [61]
    with np.errstate(divide="ignore"):
        log10_minp = np.log10(1.0 - np.power(10.0, log10p))
    coeff = (
        _lgamma(obs + 1) - _lgamma(mism + 1) - _lgamma(obs - mism + 1)
    ) * _LOG10E  # [...] per entry
    p2 = coeff[..., None] + log10p[None, :] * mism[..., None] + log10_minp[None, :] * (
        obs - mism
    )[..., None]
    # bin 0: log10p == 0 -> -MaxFloat64 (reference: bqsr.go:607-609)
    p2[..., 0] = -sys.float_info.max
    with np.errstate(over="ignore"):  # -MaxFloat64 + prior -> -inf, like Go
        posterior = p1 + p2
    # argmax with strict > (first max wins, bqsr.go:630-640)
    arg = np.argmax(posterior, axis=-1).astype(np.uint8)
    return np.minimum(arg, MAX_RECALIBRATED_QUAL).astype(np.uint8)


def _entry_empirical_quality(obs, mism, prior):
    """calculateEmpiricalQuality with smoothing (reference: bqsr.go:644-649)."""
    return calculate_empirical_quality(
        np.asarray(obs, np.int64) + 2, np.asarray(mism, np.int64) + 1, prior
    )


@dataclass
class BaseRecalibratorTables:
    """Dense BQSR tables (reference type: bqsr.go:447-459)."""

    rg_names: List[str]
    max_cycle: int
    qs_obs: np.ndarray  # [nRG, 94] int64
    qs_mism: np.ndarray
    cyc_obs: np.ndarray  # [nRG, 94, 2*maxCycle+1]
    cyc_mism: np.ndarray
    ctx_obs: np.ndarray  # [nRG, 94, 16]
    ctx_mism: np.ndarray
    qs_eq: Optional[np.ndarray] = None  # finalized empirical qualities

    @staticmethod
    def zeros(rg_names: List[str], max_cycle: int) -> "BaseRecalibratorTables":
        n = len(rg_names)
        ncyc = 2 * max_cycle + 1
        return BaseRecalibratorTables(
            rg_names=list(rg_names),
            max_cycle=max_cycle,
            qs_obs=np.zeros((n, NQUAL), np.int64),
            qs_mism=np.zeros((n, NQUAL), np.int64),
            cyc_obs=np.zeros((n, NQUAL, ncyc), np.int64),
            cyc_mism=np.zeros((n, NQUAL, ncyc), np.int64),
            ctx_obs=np.zeros((n, NQUAL, NCTX), np.int64),
            ctx_mism=np.zeros((n, NQUAL, NCTX), np.int64),
        )

    def merge(self, other: "BaseRecalibratorTables") -> "BaseRecalibratorTables":
        """Commutative table sum (reference: bqsr.go:210-223); requires the
        same rg_names/max_cycle layout (remap first otherwise)."""
        assert self.rg_names == other.rg_names and self.max_cycle == other.max_cycle
        self.qs_obs += other.qs_obs
        self.qs_mism += other.qs_mism
        self.cyc_obs += other.cyc_obs
        self.cyc_mism += other.cyc_mism
        self.ctx_obs += other.ctx_obs
        self.ctx_mism += other.ctx_mism
        return self

    # -- finalize (reference: bqsr.go:676-694) --

    def finalize(self) -> None:
        quals = np.arange(NQUAL, dtype=np.float64)
        self.qs_eq = _entry_empirical_quality(
            self.qs_obs, self.qs_mism, np.broadcast_to(quals, self.qs_obs.shape)
        )

    # -- combined per-RG table (reference: bqsr.go:651-674) --

    def combined_rg_table(self) -> Dict[str, Tuple[float, int, int, int]]:
        """rg -> (reportedQuality, EmpiricalQuality, Observations, Mismatches)."""
        out = {}
        quals = np.arange(NQUAL, dtype=np.float64)
        err_prob = np.power(10.0, quals / -10.0)
        for i, rg in enumerate(self.rg_names):
            obs = self.qs_obs[i]
            total_obs = int(obs.sum())
            if total_obs == 0:
                continue
            total_mism = int(self.qs_mism[i].sum())
            sum_errors = float((obs * err_prob).sum())
            reported = -10.0 * math.log10(sum_errors / total_obs)
            eq = int(
                _entry_empirical_quality(
                    np.array([total_obs]), np.array([total_mism]), np.array([reported])
                )[0]
            )
            out[rg] = (reported, eq, total_obs, total_mism)
        return out

    # -- quantization (reference: bqsr.go:745-899) --

    def quantization(self, levels: int) -> Tuple[np.ndarray, np.ndarray]:
        """(quantizationMap observations, quantizedScores) for QualityScores."""
        qmap = np.zeros(MAX_QUALITY_SCORE + 1, np.int64)
        scores = np.arange(MAX_QUALITY_SCORE + 1).astype(np.uint8)
        if levels == 0:
            return qmap, scores
        if self.qs_eq is None:
            self.finalize()
        present = self.qs_obs > 0
        np.add.at(qmap, self.qs_eq[present].astype(np.int64), self.qs_obs[present])
        ivals = _initialize_quantization_intervals(qmap.tolist())
        _merge_quantization_intervals(ivals, levels)
        scores = np.zeros(MAX_QUALITY_SCORE + 1, np.uint8)
        i = 0
        while i >= 0:
            interval = ivals[i]
            if _leaf_interval(i, interval):
                qscore = i
            else:
                error_rate = _calculate_error_rate(interval["nobs"], interval["nerrors"])
                qscore = _error_probability_to_quality(error_rate)
            kend = interval["next"] if interval["next"] >= 0 else len(ivals)
            scores[i:kend] = qscore
            i = interval["next"]
        return qmap, scores


def _calculate_error_rate(nobs: int, nerrors: int) -> float:
    """(reference: bqsr.go:788-793)"""
    if nobs == 0:
        return 0.0
    return (nerrors + 1) / (nobs + 1)


def _error_probability_to_quality(prob: float) -> int:
    """(reference: bqsr.go:701-706), Go math.Round = half away from zero."""
    if prob == 0.0:
        return MAX_QUALITY_SCORE
    v = int(math.floor(abs(-10 * math.log10(prob)) + 0.5)) * (1 if -10 * math.log10(prob) >= 0 else -1)
    return max(min(v, MAX_QUALITY_SCORE), 1)


def _initialize_quantization_intervals(qmap: List[int]) -> List[dict]:
    """(reference: bqsr.go:760-778)"""
    ivals = []
    for i, nobs in enumerate(qmap):
        error_rate = 10 ** (i / -10.0)
        nerrors = int(nobs * error_rate)
        nxt = i + 1 if i + 1 < len(qmap) else -1
        ivals.append(
            {"next": nxt, "errorRate": error_rate, "nobs": nobs, "leafNobs": nobs, "nerrors": nerrors}
        )
    return ivals


def _leaf_interval(index: int, interval: dict) -> bool:
    """(reference: bqsr.go:753-758)"""
    if interval["next"] < 0:
        return index == MAX_QUALITY_SCORE
    return interval["next"] == index + 1


def _leaf_penalty(k: int, ivals: List[dict], global_error_rate: float) -> float:
    """(reference: bqsr.go:780-786)"""
    if k <= MIN_INTERESTING_QUAL:
        return 0.0
    interval = ivals[k]
    return abs(math.log10(interval["errorRate"]) - math.log10(global_error_rate)) * interval["leafNobs"]


def _compute_merge_penalty(i: int, j: int, ivals: List[dict]) -> float:
    """(reference: bqsr.go:795-818)"""
    merged_nobs = ivals[i]["nobs"] + ivals[j]["nobs"]
    merged_nerrors = ivals[i]["nerrors"] + ivals[j]["nerrors"]
    merged_error_rate = _calculate_error_rate(merged_nobs, merged_nerrors)
    if merged_error_rate == 0:
        return 0.0
    total = 0.0
    for k in range(i, j):
        total += _leaf_penalty(k, ivals, merged_error_rate)
    kend = ivals[j]["next"] if ivals[j]["next"] >= 0 else len(ivals)
    for k in range(j, kend):
        total += _leaf_penalty(k, ivals, merged_error_rate)
    return total


def _merge_quantization_intervals(ivals: List[dict], levels: int) -> None:
    """(reference: bqsr.go:820-861)"""
    n = len(ivals)
    while n > levels:
        # find adjacent pair with minimal merge penalty (bqsr.go:820-850)
        i = 0
        j = ivals[0]["next"]
        if j < 0:
            break
        min_i = 0
        min_penalty = _compute_merge_penalty(0, j, ivals)
        while True:
            i = j
            j = ivals[i]["next"]
            if j < 0:
                break
            penalty = _compute_merge_penalty(i, j, ivals)
            if penalty < min_penalty:
                min_i = i
                min_penalty = penalty
        tgt = ivals[min_i]
        nxt = ivals[tgt["next"]]
        tgt["nobs"] += nxt["nobs"]
        tgt["nerrors"] += nxt["nerrors"]
        tgt["next"] = nxt["next"]
        n -= 1


def initialize_static_quantized_scores(quals: Sequence[int]) -> np.ndarray:
    """--sqq static quantization (reference: bqsr.go:710-743)."""
    MAXQ = 254
    static = np.zeros(MAXQ, np.uint8)
    for i in range(MIN_INTERESTING_QUAL):
        static[i] = i
    quals = list(quals)
    if len(quals) == 1:
        static[MIN_INTERESTING_QUAL:MAXQ] = quals[0]
        return static
    quals.sort()
    prev_qual = MIN_INTERESTING_QUAL
    prev_prob = 1 - 10 ** (prev_qual / -10.0)
    for next_qual in quals:
        for i in range(prev_qual, next_qual):
            next_prob = 1 - 10 ** (next_qual / -10.0)
            i_prob = 1 - 10 ** (i / -10.0)
            if i_prob - prev_prob > next_prob - i_prob:
                static[i] = next_qual
            else:
                static[i] = prev_qual
            prev_prob = next_prob
            prev_qual = next_qual
    for i in range(prev_qual, MAXQ):
        static[i] = prev_qual
    return static


# ---------------------------------------------------------------------------
# Recalibrate (table build)
# ---------------------------------------------------------------------------


def rg_covariate_map(header: Header) -> Dict[bytes, str]:
    """@RG ID -> covariate string (PU if present, else ID)
    (reference: bqsr.go:35-51)."""
    out: Dict[bytes, str] = {}
    for record in header.rg:
        rg_id = record.get("ID")
        if rg_id is None:
            continue
        out[rg_id.encode()] = record.get("PU", rg_id)
    return out


class BaseRecalibrator:
    """First step of base recalibration (reference: bqsr.go:416-443)."""

    def __init__(self, known_sites: Sequence[str], ref: "RefIndex") -> None:
        self.ref = ref
        self.known: Dict[str, np.ndarray] = {}
        for path in known_sites:
            for chrom, ivals in iv.from_elsites_file(path).items():
                if chrom in self.known:
                    self.known[chrom] = np.concatenate([self.known[chrom], ivals])
                else:
                    self.known[chrom] = ivals
        for chrom in self.known:
            self.known[chrom] = iv.flatten(iv.sort_by_start(self.known[chrom]))

    def recalibrate(self, header: Header, batch: ReadBatch, max_cycle: int,
                    pool=None, device=None) -> BaseRecalibratorTables:
        """(reference: bqsr.go:467-551). The table build runs on
        ``device`` (``None``: the session default). On the CPU, with
        ``pool`` (an hc.parallel.HCWorkerPool) and more than 4096 reads,
        the host prep and the native table build fan out over the worker
        processes; the scatter-add tables are commutative, so the result
        is identical. On ``cuda`` the build stays on the card in this
        process and ``pool`` is not used."""
        rgmap = rg_covariate_map(header)
        cov_names = sorted(set(rgmap.values()))
        tables = BaseRecalibratorTables.zeros(cov_names, max_cycle)
        n = len(batch)
        if n == 0:
            return tables
        nrg = len(cov_names)
        ncyc = 2 * max_cycle + 1
        dev = _device.resolve(device)
        if pool is not None and n > 4096 and dev.type == "cpu":
            from types import SimpleNamespace

            lite = SimpleNamespace(
                ref=SimpleNamespace(offsets=self.ref.offsets), known=self.known)
            # workers run prep AND the table build on their own chunk and
            # return only the (tiny) partial tables
            partials = pool.map_bqsr_tables(lite, header, batch, max_cycle,
                                            self.ref.classes)
        else:
            p = prep_recalibrate_columns(self, header, batch, None, max_cycle)
            preps = [p] if p["m"] > 0 else []
            partials = [accumulate_table_partials(
                preps, self.ref.classes, max_cycle, nrg, device=dev)]
        max_abs_cycle = 0
        for acc, mac in partials:
            max_abs_cycle = max(max_abs_cycle, mac)
            if acc is None:
                continue
            tables.qs_obs += acc[0].reshape(nrg, NQUAL)
            tables.qs_mism += acc[1].reshape(nrg, NQUAL)
            tables.cyc_obs += acc[2].reshape(nrg, NQUAL, ncyc)
            tables.cyc_mism += acc[3].reshape(nrg, NQUAL, ncyc)
            tables.ctx_obs += acc[4].reshape(nrg, NQUAL, NCTX)
            tables.ctx_mism += acc[5].reshape(nrg, NQUAL, NCTX)
        if max_abs_cycle > max_cycle:
            raise ValueError("cycle value exceeds maximum cycle value")
        return tables


def accumulate_table_partials(preps: List[dict], ref_classes: np.ndarray,
                              max_cycle: int, n_rg: int,
                              max_rows: int = 1 << 17, device=None):
    """Run the table build over FIXED-SIZE row slices of ``preps`` and
    sum the results: bounded device buffers at WGS scale, identical
    tables (scatter-adds commute). Returns
    ``(six_flat_int32_arrays_or_None, max_abs_cycle)``.

    On the CPU the fused native engine builds each slice's tables (the
    torch covariate codes + a histogram when the native library is
    missing). On ``cuda`` the packed torch build runs on the card (the
    dense one when the bases exceed a 16-symbol alphabet), with the
    running sum kept on the card and fetched once after the loop."""
    from ..ops.dispatch import routes_to_host
    from ..ops.packed import pack_bits, pack_nibble_dict

    total = sum(p["n_real"] for p in preps)
    dev = _device.resolve(device)
    host = routes_to_host(total, dev)
    acc = None
    max_abs_cycle = 0
    dev_acc = None  # on-device running table sum (cuda path)
    dev_mac = None
    nrg_q = n_rg * NQUAL
    sizes = (nrg_q, nrg_q * (2 * max_cycle + 1), nrg_q * NCTX)
    for sl in _iter_prep_slices(preps, max_rows=max_rows):
        cols = (sl["qual"], sl["seq_len"], sl["flag"], sl["pos"], sl["rg"],
                sl["refoff"])
        if host:
            # fused native engine: covariates + histograms in one pass,
            # no [rows, L] intermediates at all (recalibrate_codes is
            # its oracle)
            from .. import native

            arrs = None
            got = native.bqsr_covariate_tables(sl, ref_classes, max_cycle,
                                               n_rg)
            if got is not None:
                arrs, mac = got
            else:
                qs_idx, cyc_idx, ctx_idx, err, mac = (
                    t.numpy() for t in bqsr_ops.recalibrate_codes(
                        sl["base"], *cols, sl["skip"], sl["op_class"],
                        sl["op_len"], ref_classes, max_cycle=max_cycle,
                        n_rg=n_rg, device=dev))
                errb = err.astype(bool)
                arrs = []
                for idx, size in zip((qs_idx, cyc_idx, ctx_idx), sizes):
                    # cycle values beyond max_cycle produce out-of-range
                    # (even negative) indices; they drop here so the
                    # clean cycle-range ValueError is what raises
                    idx = np.where((idx < 0) | (idx > size), size, idx)
                    arrs.append(np.bincount(idx, minlength=size + 1)
                                [:size].astype(np.int32))
                    arrs.append(np.bincount(idx[errb], minlength=size + 1)
                                [:size].astype(np.int32))
            max_abs_cycle = max(max_abs_cycle, int(mac))
            if acc is None:
                acc = [a.copy() for a in arrs]
            else:
                for i in range(6):
                    acc[i] += arrs[i]
            continue
        rest = (sl["op_class"], sl["op_len"], ref_classes)
        packed = pack_nibble_dict(sl["base"])
        if packed is not None:
            # 4-bit-dict bases + bit-packed skip, unpacked on the card
            # (ops/packed): the dense [rows, L] forms never cross the link
            bp, lut = packed
            out = bqsr_ops.recalibrate_tables_packed(
                bp, lut, *cols, pack_bits(sl["skip"]), *rest,
                max_cycle=max_cycle, n_rg=n_rg, width=sl["base"].shape[1],
                device=dev)
        else:
            out = bqsr_ops.recalibrate_tables(
                sl["base"], *cols, sl["skip"], *rest, max_cycle=max_cycle,
                n_rg=n_rg, device=dev)
        # accumulate on the card and fetch once after the loop: nothing
        # blocks per slice, so slice k+1's copy overlaps slice k's work
        if dev_acc is None:
            dev_acc = list(out[:6])
            dev_mac = out[6]
        else:
            dev_acc = [a + b for a, b in zip(dev_acc, out[:6])]
            dev_mac = torch.maximum(dev_mac, out[6])
    if dev_acc is not None:
        max_abs_cycle = max(max_abs_cycle, int(dev_mac))
        acc = [a.cpu().numpy() for a in dev_acc]
    return acc, max_abs_cycle


def _iter_prep_slices(preps: List[dict], max_rows: int):
    """Yield fixed-shape row slices from per-chunk prep dicts: real rows
    concatenate across preps (per-chunk pow2 dummies dropped); each
    yielded slice has exactly min(max_rows, pow2(total)) rows at the
    shared (L, C) widths, dummy-padded (dummies contribute nothing)."""
    total = sum(p["n_real"] for p in preps)
    if total == 0:
        return
    rows = 1
    while rows < total:
        rows *= 2
    rows = min(rows, max_rows)
    L = max(p["L"] for p in preps)
    C = max(p["C"] for p in preps)

    def fresh():
        return dict(
            m=rows, L=L, C=C,
            base=np.zeros((rows, L), np.uint8),
            qual=np.zeros((rows, L), np.uint8),
            skip=np.zeros((rows, L), bool),
            seq_len=np.zeros(rows, np.int32),
            flag=np.zeros(rows, np.int32),
            pos=np.zeros(rows, np.int32),
            rg=np.zeros(rows, np.int32),
            refoff=np.zeros(rows, np.int64),
            op_class=np.full((rows, C), bqsr_ops.OP_CLASS[ord("S")], np.int8),
            op_len=np.zeros((rows, C), np.int32),
        )

    keys_2d = ("base", "qual", "skip", "op_class", "op_len")
    keys_1d = ("seq_len", "flag", "pos", "rg", "refoff")
    sl = fresh()
    fill = 0
    for p in preps:
        src = 0
        n_real = p["n_real"]
        while src < n_real:
            take = min(n_real - src, rows - fill)
            for k in keys_2d:
                sl[k][fill : fill + take, : p[k].shape[1]] = p[k][src : src + take]
            for k in keys_1d:
                sl[k][fill : fill + take] = p[k][src : src + take]
            fill += take
            src += take
            if fill == rows:
                yield sl
                sl = fresh()
                fill = 0
    if fill:
        yield sl


def prep_recalibrate_columns(recal: "BaseRecalibrator", header: Header,
                             batch: ReadBatch, row_subset, max_cycle: int) -> dict:
    """Host side of the BQSR table build for a row subset: eligibility
    gate, adaptor/soft-clip hard clipping, dense padded covariate columns
    (reference: bqsr.go:225-285,389-414). ``row_subset`` of None means
    all rows. Returns a dict of arrays plus ``m``/``L``/``C`` (rows are
    padded to a power of two; dummies contribute nothing)."""
    rgmap = rg_covariate_map(header)
    cov_names = sorted(set(rgmap.values()))
    cov_index = {name: i for i, name in enumerate(cov_names)}

    eligible, rg_vals = _recalibrate_eligibility(header, batch)
    if row_subset is not None:
        sub = np.zeros(len(batch), bool)
        sub[row_subset] = True
        eligible = eligible & sub
    rows = np.flatnonzero(eligible)
    self = recal
    empty = dict(m=0, n_real=0, L=0, C=0,
                 base=np.zeros((0, 0), np.uint8), qual=np.zeros((0, 0), np.uint8),
                 skip=np.zeros((0, 0), bool), seq_len=np.zeros(0, np.int32),
                 flag=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
                 rg=np.zeros(0, np.int32), refoff=np.zeros(0, np.int64),
                 op_class=np.zeros((0, 0), np.int8), op_len=np.zeros((0, 0), np.int32))
    if len(rows) == 0:
        return empty

    fast = _prep_recal_native(recal, header, batch, rows, rgmap, cov_index,
                              rg_vals, empty)
    if fast is not None:
        return fast

    # host fallback (oracle): clip adaptor + soft clips per eligible
    # read; collect clipped views
    clipped: List[clipping.ClipRead] = []
    names = batch.names
    for i in rows:
        r = clipping.ClipRead(
            flag=int(batch.flag[i]),
            pos=int(batch.pos[i]),
            pnext=int(batch.pnext[i]),
            tlen=int(batch.tlen[i]),
            mapq=int(batch.mapq[i]),
            cigar=list(zip(batch.cigar_len.row(i).tolist(), batch.cigar_op.row(i).tobytes().decode())),
            seq=batch.seq.row(i).tobytes(),
            qual=batch.qual.row(i).tobytes(),
            rname=names[batch.rname_id[i]],
            rnext=names[batch.rnext_id[i]],
            row=int(i),
        )
        clipping.hard_clip_adaptor_sequence(r)
        if len(r.seq) == 0:
            continue
        clipping.hard_clip_soft_clipped_bases(r)
        if len(r.seq) == 0:
            continue
        clipped.append(r)
    if not clipped:
        return empty

    n_real = len(clipped)
    # rows padded to a power of two and widths to buckets, the JAX
    # package's shapes (dummy rows have seq_len 0 and contribute nothing)
    m = 1
    while m < n_real:
        m *= 2
    L = ((max(len(r.seq) for r in clipped) + 31) // 32) * 32
    C = ((max(len(r.cigar) for r in clipped) + 7) // 8) * 8
    base = np.zeros((m, L), np.uint8)
    qual = np.zeros((m, L), np.uint8)
    skip = np.zeros((m, L), bool)
    seq_len = np.zeros(m, np.int32)
    flag = np.zeros(m, np.int32)
    pos = np.zeros(m, np.int32)
    rg = np.zeros(m, np.int32)
    refoff = np.zeros(m, np.int64)
    op_class = np.full((m, C), bqsr_ops.OP_CLASS[ord("S")], np.int8)
    op_len = np.zeros((m, C), np.int32)

    for k, r in enumerate(clipped):
        sl = len(r.seq)
        base[k, :sl] = np.frombuffer(r.seq, np.uint8)
        qual[k, :sl] = np.frombuffer(r.qual, np.uint8)
        seq_len[k] = sl
        flag[k] = r.flag
        pos[k] = r.pos
        rg[k] = cov_index[rgmap[rg_vals[r.row]]]
        refoff[k] = self.ref.offsets[r.rname.decode()]
        for c, (ln, op) in enumerate(r.cigar):
            op_class[k, c] = bqsr_ops.OP_CLASS[ord(op)]
            op_len[k, c] = ln
        # known-sites skip slice (reference: bqsr.go:389-414)
        ksites = self.known.get(r.rname.decode())
        if ksites is not None and len(ksites):
            ss = clipping.soft_start(r)
            se = clipping.soft_end(r)
            for s_start, s_end in iv.intersect(ksites, ss, se):
                fs, ok = clipping.get_read_coordinate_for_reference_coordinate(
                    r.cigar, ss, int(s_start), clipping.LEFT
                )
                if not ok or fs < 0:
                    fs = 0
                fe, ok = clipping.get_read_coordinate_for_reference_coordinate(
                    r.cigar, ss, int(s_end), clipping.LEFT
                )
                if not ok or fe > sl - 1:
                    fe = sl - 1
                skip[k, fs : fe + 1] = True

    return dict(m=m, n_real=n_real, L=L, C=C, base=base, qual=qual, skip=skip,
                seq_len=seq_len, flag=flag, pos=pos, rg=rg, refoff=refoff,
                op_class=op_class, op_len=op_len)


_REFCONS_LUT = np.zeros(256, np.int64)
for _c in b"MDN=X":
    _REFCONS_LUT[_c] = 1
# ASCII op char -> OP_CLASS id (OP_CLASS itself is a dict)
_OPCLASS_LUT = np.zeros(256, np.int8)
for _c in bqsr_ops.CIGAR_OPS:
    _OPCLASS_LUT[_c] = bqsr_ops.OP_CLASS[_c]


def _prep_recal_native(recal, header, batch, rows, rgmap, cov_index, rg_vals,
                       empty):
    """Native fast path of prep_recalibrate_columns: the adaptor +
    soft-clip chain runs batched in C++ (clipping_native.cpp; oracle is
    the Python loop below) and the padded covariate columns assemble
    from the columnar outputs. Returns the same dict as the fallback, or
    None when the native lib is unavailable."""
    from .. import native

    if not native.available() or os.environ.get("ELPREP_TPU_NO_NATIVE_CLIP"):
        return None
    rows = np.asarray(rows, np.int64)
    sub_cl = batch.cigar_len.gather(rows)
    sub_co = batch.cigar_op.gather(rows)
    sub_q = batch.qual.gather(rows)
    star = np.array([nm in (b"*", b"") for nm in batch.names] or [True],
                    np.uint8)
    got = native.clip_reads(
        batch.flag[rows], batch.pos[rows], batch.pnext[rows],
        batch.tlen[rows], batch.mapq[rows],
        (sub_cl.data, sub_co.data, sub_cl.offsets),
        sub_q.data, sub_q.offsets,
        star[batch.rname_id[rows]], star[batch.rnext_id[rows]],
        native.CLIP_ADAPTOR | native.CLIP_SOFTCLIP)
    if got is None:
        return None
    blen_all = got["blen"]
    kr = np.flatnonzero(blen_all > 0)
    n_real = len(kr)
    if n_real == 0:
        return empty
    self = recal
    bl = blen_all[kr]
    n_ops_k = got["n_ops"][kr].astype(np.int64)
    m = 1
    while m < n_real:
        m *= 2
    L = ((int(bl.max()) + 31) // 32) * 32
    C = ((int(n_ops_k.max()) + 7) // 8) * 8

    def _pad_off(off):
        return np.concatenate([off, np.full(m - n_real, off[-1], np.int64)])

    bs_k = got["bstart"][kr]
    seq_starts = batch.seq.offsets[rows[kr]] + bs_k
    base_fr = native.ranged_gather_u8(batch.seq.data, seq_starts,
                                      seq_starts + bl)
    qual_starts = batch.qual.offsets[rows[kr]] + bs_k
    qual_fr = native.ranged_gather_u8(batch.qual.data, qual_starts,
                                      qual_starts + bl)
    cb = got["cig_base"][kr]
    ops_fr = native.ranged_gather_u8(got["ops"], cb, cb + n_ops_k)
    lens_fr = native.ranged_gather_u8(got["lens"].view(np.uint8), cb * 4,
                                      (cb + n_ops_k) * 4)
    if base_fr is None or qual_fr is None or ops_fr is None or lens_fr is None:
        return None
    base = native.ragged_to_padded(base_fr[0], _pad_off(base_fr[1]), L, 0,
                                   np.uint8)
    qual = native.ragged_to_padded(qual_fr[0], _pad_off(qual_fr[1]), L, 0,
                                   np.uint8)
    s_class = bqsr_ops.OP_CLASS[ord("S")]
    op_class = native.ragged_to_padded(
        _OPCLASS_LUT[ops_fr[0]], _pad_off(ops_fr[1]), C, s_class, np.int8)
    op_len_flat = lens_fr[0].view(np.int32)
    op_len = native.ragged_to_padded(op_len_flat, _pad_off(lens_fr[1] // 4),
                                     C, 0, np.int32)
    if base is None or qual is None or op_class is None or op_len is None:
        return None

    seq_len = np.zeros(m, np.int32)
    seq_len[:n_real] = bl
    flag = np.zeros(m, np.int32)
    flag[:n_real] = got["flag"][kr]
    pos = np.zeros(m, np.int32)
    pos[:n_real] = got["pos"][kr]
    rg = np.zeros(m, np.int32)
    vals_k = rg_vals[rows[kr]]
    uq_v, inv_v = np.unique(vals_k, return_inverse=True)
    rg[:n_real] = np.array([cov_index[rgmap[v]] for v in uq_v],
                           np.int32)[inv_v]
    refoff = np.zeros(m, np.int64)
    rid_k = batch.rname_id[rows[kr]]
    uq_r, inv_r = np.unique(rid_k, return_inverse=True)
    refoff[:n_real] = np.array(
        [self.ref.offsets[batch.names[q].decode()] for q in uq_r],
        np.int64)[inv_r]

    # known-sites skip slices (reference: bqsr.go:389-414): candidate
    # rows via a safe overapproximation of [soft_start, soft_end], exact
    # Python logic for the (rare) overlapping reads
    skip = np.zeros((m, L), bool)
    refcons = _REFCONS_LUT[ops_fr[0]] * op_len_flat
    rc_cum = np.concatenate([[0], np.cumsum(refcons)])
    reflen = rc_cum[ops_fr[1][1:]] - rc_cum[ops_fr[1][:-1]]
    pos_k = got["pos"][kr]
    lo = pos_k - bl - 1
    hi = pos_k + reflen + bl + 1
    ops_s = ops_fr[0].tobytes().decode("latin1")
    use_native_skip = (not os.environ.get("ELPREP_TPU_NO_NATIVE_SKIP")
                       and hasattr(native.get_lib() or (), "bqsr_skip_sites"))
    for q in uq_r:
        nm = batch.names[q].decode()
        ksites = self.known.get(nm)
        if ksites is None or not len(ksites):
            continue
        sel = np.flatnonzero(rid_k == q)
        cand_lo = np.searchsorted(ksites[:, 1], lo[sel], side="left")
        cand_hi = np.searchsorted(ksites[:, 0], hi[sel], side="right")
        cands = sel[np.flatnonzero(cand_lo < cand_hi)]
        if use_native_skip and native.bqsr_skip_sites(
                cands, pos_k, ops_fr[1][:-1], n_ops_k, op_len_flat,
                ops_fr[0], bl, ksites, skip):
            continue
        for k in cands:
            f0 = int(ops_fr[1][k])
            mo = int(n_ops_k[k])
            r = clipping.ClipRead(
                flag=int(flag[k]), pos=int(pos_k[k]), pnext=0, tlen=0,
                mapq=0,
                cigar=list(zip(op_len_flat[f0:f0 + mo].tolist(),
                               ops_s[f0:f0 + mo])),
                seq=b"", qual=b"")
            sl = int(bl[k])
            ss = clipping.soft_start(r)
            se = clipping.soft_end(r)
            for s_start, s_end in iv.intersect(ksites, ss, se):
                fs, ok = clipping.get_read_coordinate_for_reference_coordinate(
                    r.cigar, ss, int(s_start), clipping.LEFT)
                if not ok or fs < 0:
                    fs = 0
                fe, ok = clipping.get_read_coordinate_for_reference_coordinate(
                    r.cigar, ss, int(s_end), clipping.LEFT)
                if not ok or fe > sl - 1:
                    fe = sl - 1
                skip[k, fs:fe + 1] = True

    return dict(m=m, n_real=n_real, L=L, C=C, base=base, qual=qual, skip=skip,
                seq_len=seq_len, flag=flag, pos=pos, rg=rg, refoff=refoff,
                op_class=op_class, op_len=op_len)


def _recalibrate_eligibility(header: Header, batch: ReadBatch) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized recalibrateAln (reference: bqsr.go:225-244).
    Returns (eligible mask, RG tag values)."""
    n = len(batch)
    rg_vals = batch.tags.extract_z(b"RG")
    has_sr = batch.tags.has_tag(b"sr")
    mapq_ok = (batch.mapq > 0) & (batch.mapq < 255)
    flags_ok = (batch.flag & (SECONDARY | DUPLICATE | QC_FAILED)) == 0
    star = np.array([nm in (b"*", b"") for nm in batch.names], bool)[batch.rname_id] if batch.names else np.zeros(n, bool)
    strict_mapped = ((batch.flag & 0x4) == 0) & (batch.pos != 0) & ~star
    seq_lens = batch.seq.lengths
    qual_lens = batch.qual.lengths
    has_rg = rg_vals != b""

    # alignmentAgreesWithHeader (reference: filters/utils.go:130-138)
    ln_by_name = {e["SN"].encode(): int(e["LN"]) for e in header.sq if "SN" in e and "LN" in e}
    pool_ln = np.array([ln_by_name.get(nm, -1) for nm in batch.names], np.int64) if batch.names else np.zeros(0, np.int64)
    lns = pool_ln[batch.rname_id] if batch.names else np.full(n, -1, np.int64)
    agrees = (lns >= 0) & (batch.pos <= lns)

    # CIGAR checks: no N op; read length from cigar == seq length
    op_class, op_len, n_ops = pad_cigars(batch.cigar_len, batch.cigar_op)
    has_n = (op_class == bqsr_ops.OP_CLASS[ord("N")]).any(axis=1) if op_class.size else np.zeros(n, bool)
    rdlen = (np.asarray(bqsr_ops._READ_CONS)[op_class.astype(np.int32)] * op_len).sum(axis=1) if op_class.size else np.zeros(n, np.int64)

    eligible = (
        ~has_sr
        & mapq_ok
        & flags_ok
        & strict_mapped
        & (batch.pos > 0)
        & (seq_lens > 0)
        & (seq_lens == qual_lens)
        & has_rg
        & agrees
        & ~has_n
        & (rdlen == seq_lens)
    )
    return eligible, rg_vals


# ---------------------------------------------------------------------------
# ApplyBQSR
# ---------------------------------------------------------------------------


def build_apply_tables(tables: BaseRecalibratorTables):
    """Precompute the integer delta tables used by the device apply kernel.

    The hierarchical estimate (reference: bqsr.go:901-919) collapses to
    condPrior + Δcycle + Δcontext with

      condPrior[rg,q]  = EQ(QS[rg,q], prior=EQ_rg) if present else EQ_rg
      Δcycle[rg,q,c]   = EQ(Cycles[rg,q,c], prior=condPrior) - condPrior
      Δcontext[rg,q,x] = EQ(Contexts[rg,q,x], prior=condPrior) - condPrior

    where EQ_rg = EQ(combined RG entry, prior=epsilon) and epsilon is the
    combined reportedQuality — all EQ values are integers.
    """
    nrg = len(tables.rg_names)
    combined = tables.combined_rg_table()
    rg_present = np.zeros(nrg, bool)
    eq_rg = np.zeros(nrg, np.int32)
    for i, rg in enumerate(tables.rg_names):
        if rg in combined:
            rg_present[i] = True
            eq_rg[i] = combined[rg][1]

    # condPrior per (rg, qual)
    qs_present = tables.qs_obs > 0
    prior_q = np.broadcast_to(eq_rg[:, None].astype(np.float64), tables.qs_obs.shape)
    eq_qs = _entry_empirical_quality(tables.qs_obs, tables.qs_mism, prior_q)
    cond_prior = np.where(qs_present, eq_qs.astype(np.int32), eq_rg[:, None])

    # deltas for cycles/contexts
    cpf = cond_prior.astype(np.float64)
    d_cyc = np.zeros(tables.cyc_obs.shape, np.int32)
    pres = tables.cyc_obs > 0
    if pres.any():
        eq = _entry_empirical_quality(
            tables.cyc_obs[pres], tables.cyc_mism[pres],
            np.broadcast_to(cpf[:, :, None], tables.cyc_obs.shape)[pres],
        )
        d_cyc[pres] = eq.astype(np.int32) - np.broadcast_to(cond_prior[:, :, None], tables.cyc_obs.shape)[pres]

    d_ctx17 = np.zeros(tables.ctx_obs.shape[:2] + (NCTX + 1,), np.int32)
    pres = tables.ctx_obs > 0
    if pres.any():
        eq = _entry_empirical_quality(
            tables.ctx_obs[pres], tables.ctx_mism[pres],
            np.broadcast_to(cpf[:, :, None], tables.ctx_obs.shape)[pres],
        )
        d_ctx17[:, :, :NCTX][pres] = (
            eq.astype(np.int32) - np.broadcast_to(cond_prior[:, :, None], tables.ctx_obs.shape)[pres]
        )
    return cond_prior, d_cyc, d_ctx17, rg_present


def _writeback_quals(batch, newq: np.ndarray) -> None:
    """Write recalibrated [n, width] quals back into the ragged buffer.

    The native row-wise memcpy replaces the dense boolean-mask gather,
    which materialized an [n, width] mask plus a 100M+-element fancy
    index at WGS scale (~6 s/1M reads -> ~0.05 s; fuzz-pinned twin in
    tests/test_native.py)."""
    total = int(batch.qual.offsets[-1])
    if not total:
        return
    from .. import native

    newq = np.ascontiguousarray(newq, dtype=batch.qual.data.dtype)
    if native.padded_to_ragged(newq, batch.qual.offsets, batch.qual.data):
        return
    lens = batch.qual.lengths.astype(np.int64)
    cols = np.arange(newq.shape[1])
    mask = cols[None, :] < lens[:, None]
    batch.qual.data[:] = newq[mask]


def apply_bqsr_filter(
    tables: BaseRecalibratorTables,
    quantize_levels: int = 0,
    sqq: Sequence[int] = (),
    max_cycle: int = 500,
    device=None,
):
    """Pipeline filter applying BQSR to QUAL columns
    (reference: bqsr.go:936-1006). On the CPU the native engines apply
    in place; on ``cuda`` (``device``, ``None``: the session default)
    the torch apply runs on the card over slices of APPLY_ROWS reads."""

    def filter_(header: Header):
        rgmap = rg_covariate_map(header)
        cov_index = {name: i for i, name in enumerate(tables.rg_names)}
        cond_prior, d_cyc, d_ctx, rg_present = build_apply_tables(tables)
        _, quant = tables.quantization(quantize_levels)
        if len(sqq) > 0:
            sqq_lut = initialize_static_quantized_scores(list(sqq))
        else:
            sqq_lut = np.arange(255, dtype=np.uint8)

        def bf(batch: ReadBatch):
            n = len(batch)
            if n == 0:
                return None
            rg_vals = batch.tags.extract_z(b"RG")
            # unique-RG lookup table instead of a per-read dict walk
            uq, inv = np.unique(rg_vals, return_inverse=True)
            lut = np.empty(len(uq), np.int32)
            for j, rgv in enumerate(uq):
                cov = rgmap.get(rgv)
                if cov is None:
                    if rgv == b"":
                        raise ValueError(
                            "BQSR requires input with read groups. Please fix input,"
                            " e.g. rerun with the --replace-read-group option."
                        )
                    cov = bytes(rgv).decode()
                lut[j] = cov_index.get(cov, -1)
            rg = lut[inv].astype(np.int32)
            from ..ops.dispatch import routes_to_host

            host = routes_to_host(n, device)
            if host:
                # ragged in-place apply: no padded [n, width] base/qual/
                # newq intermediates and no writeback pass
                from .. import native

                same_off = (batch.seq.offsets is batch.qual.offsets
                            or np.array_equal(batch.seq.offsets,
                                              batch.qual.offsets))
                if same_off:
                    mac = native.bqsr_apply_quals_ragged(
                        batch.seq.data, batch.qual.data, batch.qual.offsets,
                        batch.flag, rg, rg_present, cond_prior, d_cyc, d_ctx,
                        quant, sqq_lut, max_cycle)
                    if mac is not None:
                        if mac > max_cycle:
                            # NOTE: the in-place apply has already
                            # mutated batch.qual by this point (unlike
                            # the padded twin, which writes back only
                            # after the check). The error is fatal at
                            # every call site — the reference panics
                            # here too (bqsr.go:947) — so the batch is
                            # deliberately left poisoned; do not catch
                            # and reuse the batch.
                            raise ValueError(
                                "cycle value exceeds maximum cycle value")
                        return None

            width = int(max(batch.qual.lengths.max(initial=0), batch.seq.lengths.max(initial=0), 1))
            width = ((width + 31) // 32) * 32
            qual_padded, qual_len = batch.qual.to_padded(width)
            base_padded, _ = batch.seq.to_padded(width)
            qual_len = qual_len.astype(np.int32)

            if host:
                # native apply engine (the torch apply_bqsr below is its
                # oracle)
                from .. import native

                got = native.bqsr_apply_quals(
                    base_padded, qual_padded, qual_len,
                    batch.flag, rg, rg_present, cond_prior, d_cyc, d_ctx,
                    quant, sqq_lut, max_cycle)
                if got is not None:
                    newq, max_abs_cycle = got
                    if max_abs_cycle > max_cycle:
                        raise ValueError(
                            "cycle value exceeds maximum cycle value")
                    _writeback_quals(batch, newq)
                    return None
            parts, macs = [], []
            for s0 in range(0, n, APPLY_ROWS):
                s1 = min(n, s0 + APPLY_ROWS)
                newq, mac = bqsr_ops.apply_bqsr(
                    base_padded[s0:s1], qual_padded[s0:s1], qual_len[s0:s1],
                    batch.flag[s0:s1], rg[s0:s1], rg_present, cond_prior,
                    d_cyc, d_ctx, quant, sqq_lut, max_cycle=max_cycle,
                    device=device)
                parts.append(newq)
                macs.append(mac)
            max_abs_cycle = max(int(m) for m in macs)
            if max_abs_cycle > max_cycle:
                raise ValueError("cycle value exceeds maximum cycle value")
            _writeback_quals(batch, np.concatenate([t.cpu().numpy() for t in parts]))
            return None

        return bf

    return filter_
