"""Base quality score recalibration as elPrep 5.1.3 computes it
(filters/bqsr.go): the covariate tables of eligible reads, the empirical
qualities of the recalibration report, and the recalibrated qualities of
every read.

Vectorised in numpy over reads x bases from the scalar oracle
tests/bqsr_oracle.py (bqsr.go:64-414, 553-706, 901-1006). It handles
the CIGARs the benchmark's fixtures have (M and soft clips); any other
operation raises. ``dtype`` sets the float precision of every empirical
quality; float64 is the reference's, float32 is the control's."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .records import Reads

MIN_INTERESTING_QUAL = 6
LOW_QUALITY_TAIL = 2
MAX_REASONABLE_QUAL = 60
MAX_RECALIBRATED_QUAL = 93
MAX_OBSERVATIONS = 2**31 - 2
NQUAL = 94
PRIOR_CACHE = np.array([
    -0.045757490560675115, -0.9143464543671788, -3.5201133457866898,
    -7.863058164819208, -13.943180911464733, -21.760481585723266,
    -31.314960187594806, -42.606616717079355, -55.63545117417691,
    -70.40146355888747, -86.90465387121104, -105.14502211114761,
    -125.1225682786972, -146.83729237385978, -170.2891943966354,
    -195.47827434702398, -222.4045322250256, -251.06796803064023,
    -281.46858176386786, -313.60637342472336, -1.7976931348623157e308])

# base -> index for contexts (A C G T, else -1) and -> class for mismatches
_IDX = np.full(256, -1, np.int64)
_CLS = np.zeros(256, np.int64)
for _k, _c in enumerate(b"ACGT"):
    _IDX[_c] = _IDX[_c + 32] = _k
    _CLS[_c] = _CLS[_c + 32] = _k + 1
_CLS[ord("*")] = 1
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b


def empirical_quality(obs, mism, prior, dtype=np.float64) -> np.ndarray:
    """The Bayesian estimate with smoothing (bqsr.go:593-649): the bin of
    0..60 with the largest posterior, first one on ties, capped at 93."""
    shape = np.shape(obs)
    obs = np.asarray(obs, np.int64).ravel() + 2
    mism = np.asarray(mism, np.int64).ravel() + 1
    prior = np.broadcast_to(np.asarray(prior, np.float64), shape).ravel()
    over = obs > MAX_OBSERVATIONS
    if over.any():
        mism = np.where(over, np.floor(mism * (MAX_OBSERVATIONS / obs) + 0.5).astype(np.int64), mism)
        obs = np.where(over, MAX_OBSERVATIONS, obs)
    f = np.dtype(dtype).type
    log10e = f(math.log10(math.e))
    coeff = np.array([f(math.lgamma(n + 1)) - f(math.lgamma(k + 1)) - f(math.lgamma(n - k + 1))
                      for n, k in zip(obs.tolist(), mism.tolist())], dtype) * log10e
    bins = np.arange(MAX_REASONABLE_QUAL + 1)
    diff = np.minimum(np.abs(np.trunc(bins[None, :] - prior[:, None])).astype(np.int64), 20)
    log10p = (bins / -10.0).astype(dtype)
    with np.errstate(divide="ignore", over="ignore"):
        p1 = PRIOR_CACHE[diff].astype(dtype)  # its last entry, -MaxFloat64, is -inf in float32
        log10_minp = np.log10(f(1) - np.power(f(10), log10p)).astype(dtype)
        p2 = (coeff[:, None] + log10p[None, :] * mism[:, None].astype(dtype)
              + log10_minp[None, :] * (obs - mism)[:, None].astype(dtype))
        p2[:, 0] = -np.finfo(dtype).max
        post = p1 + p2
    return np.minimum(np.argmax(post, axis=1), MAX_RECALIBRATED_QUAL)


def _padded(rows: List[bytes], width: int) -> np.ndarray:
    return np.frombuffer(b"".join(r.ljust(width, b"\0") for r in rows),
                         np.uint8).reshape(len(rows), width) if rows else np.zeros((0, width), np.uint8)


def _context(bases: np.ndarray, quals: np.ndarray, n: np.ndarray, rev: np.ndarray) -> np.ndarray:
    """Dense 2-mer context index (first*4 + second base of the stranded
    read) per base, -1 where none (bqsr.go:87-146, 312-362): low-quality
    tails count as N; a reverse read's context is read on the reverse
    complement and mapped back."""
    w = bases.shape[1]
    k = np.arange(w)[None, :]
    inread = k < n[:, None]
    good = (quals > LOW_QUALITY_TAIL) & inread
    left = np.where(good.any(1), good.argmax(1), w)
    right = np.where(good.any(1), w - 1 - good[:, ::-1].argmax(1), -1)
    ok = (k >= left[:, None]) & (k <= right[:, None]) & (_IDX[bases] >= 0)
    idx = _IDX[bases]
    cidx = _IDX[_COMP[bases]]
    prev_ok = np.zeros_like(ok)
    prev_ok[:, 1:] = ok[:, :-1]
    next_ok = np.zeros_like(ok)
    next_ok[:, :-1] = ok[:, 1:]
    prev = np.zeros_like(idx)
    prev[:, 1:] = idx[:, :-1]
    nxt = np.zeros_like(cidx)
    nxt[:, :-1] = cidx[:, 1:]
    fwd = np.where(ok & prev_ok, prev * 4 + idx, -1)
    bwd = np.where(ok & next_ok & (k + 1 < n[:, None]), nxt * 4 + cidx, -1)
    return np.where(rev[:, None], bwd, fwd)


def _cycles(n: np.ndarray, flag: np.ndarray, w: int) -> np.ndarray:
    """Cycle covariate per base (bqsr.go:376-386)."""
    rev = (flag & 0x10) >> 4
    last = (flag & 0x80) >> 7
    rof = 1 - 2 * last
    factor = rof + rev * (n - 1) * rof
    inc = (1 - 2 * rev) * rof
    return factor[:, None] + np.arange(w)[None, :] * inc[:, None]


class Recalibration:
    """The tables of one input and what follows from them."""

    def __init__(self, header: List[str], r: Reads, dup: List[bool],
                 genome: Dict[str, np.ndarray], known: Dict[str, np.ndarray],
                 max_cycle: int = 500, dtype=np.float64):
        self.dtype = dtype
        self.max_cycle = max_cycle
        lengths = {}
        self.pu = {}
        for ln in header:
            d = dict(f.split(":", 1) for f in ln.split("\t")[1:])
            if ln.startswith("@SQ"):
                lengths[d["SN"]] = int(d["LN"])
            elif ln.startswith("@RG"):
                self.pu[d["ID"]] = d.get("PU", d["ID"])
        self.rgs = sorted(set(self.pu.values()))
        rg_index = {rg: i for i, rg in enumerate(self.rgs)}
        nrg, ncyc = len(self.rgs), 2 * max_cycle + 1

        # eligibility and clipping, per read (bqsr.go:225-244; utils.go:214-222, 506-534)
        rows, starts, lens, rposs = [], [], [], []
        for i in range(len(r)):
            flag, pos, cig = r.flag[i], r.pos[i], r.cigar[i]
            if (dup[i] or flag & (0x100 | 0x200 | 0x400 | 0x4) or not 0 < r.mapq[i] < 255
                    or pos <= 0 or r.rname[i] not in lengths or pos > lengths[r.rname[i]]
                    or not r.seq[i] or len(r.seq[i]) != len(r.qual[i]) or not r.rg[i]):
                continue
            if any(op not in "MS" for _, op in cig):
                raise ValueError("reference BQSR handles M and S only, not %r" % (cig,))
            if any(op == "S" for _, op in cig[1:-1]) or sum(n for n, _ in cig) != len(r.seq[i]):
                continue
            lo = cig[0][0] if cig[0][1] == "S" else 0
            hi = len(r.seq[i]) - (cig[-1][0] if len(cig) > 1 and cig[-1][1] == "S" else 0)
            end = pos + (hi - lo) - 1
            # the adaptor boundary (utils.go:148-222), for reads all of whose
            # aligned bases are M
            if (r.tlen[i] != 0 and flag & 0x1 and r.rnext[i] not in ("*", "")
                    and r.pnext[i] != 0 and not flag & 0x8
                    and bool(flag & 0x10) != bool(flag & 0x20)):
                if flag & 0x10:
                    if end > r.pnext[i] and pos <= r.pnext[i] - 1 <= end:
                        cut = r.pnext[i] - 1 - pos + 1  # bases up to the boundary
                        lo, pos = lo + cut, pos + cut
                elif pos <= r.pnext[i] + r.tlen[i]:
                    b = pos + abs(r.tlen[i])
                    if pos <= b <= end:
                        hi = lo + (b - pos)
            if hi <= lo:
                continue
            rows.append(i)
            starts.append(lo)
            lens.append(hi - lo)
            rposs.append(pos)
        self.n_eligible = len(rows)
        w = max(len(s) for s in r.seq) if len(r) else 0
        full = _padded([r.seq[i] for i in rows], w)
        fullq = _padded([r.qual[i] for i in rows], w)
        st = np.array(starts, np.int64)
        n = np.array(lens, np.int64)
        k = np.arange(w)[None, :]
        src = np.minimum(st[:, None] + k, w - 1)
        bases = np.take_along_axis(full, src, 1)
        quals = np.take_along_axis(fullq, src, 1)
        inread = k < n[:, None]
        flag = np.array([r.flag[i] for i in rows], np.int64)
        rev = (flag & 0x10) != 0
        ctx = _context(bases, quals, n, rev)
        cyc = _cycles(n, flag, w)
        if np.abs(np.where(inread, cyc, 0)).max(initial=0) > max_cycle:
            raise ValueError("cycle value exceeds maximum cycle value")
        refpos = np.array(rposs, np.int64)[:, None] - 1 + k
        err = np.zeros(bases.shape, np.int64)
        skip = ~inread
        for c in set(r.rname[i] for i in rows):
            sel = np.array([r.rname[i] == c for i in rows], bool)
            g = genome[c]
            rp = np.clip(refpos[sel], 0, len(g) - 1)
            err[sel] = (_CLS[bases[sel]] != _CLS[g[rp]]).astype(np.int64)
            sites = known.get(c)
            if sites is not None and len(sites):
                j = np.clip(np.searchsorted(sites, refpos[sel]), 0, len(sites) - 1)
                skip[sel] |= sites[j] == refpos[sel]
        keep = ~skip & (_IDX[bases] >= 0) & (quals >= MIN_INTERESTING_QUAL)
        rgi = np.array([rg_index[self.pu.get(r.rg[i], r.rg[i])] for i in rows], np.int64)
        rgk = np.broadcast_to(rgi[:, None], bases.shape)[keep]
        q = quals[keep].astype(np.int64)
        e = err[keep]
        qk = rgk * NQUAL + q
        self.qs_obs = np.bincount(qk, minlength=nrg * NQUAL).reshape(nrg, NQUAL)
        self.qs_err = np.bincount(qk, e, minlength=nrg * NQUAL).astype(np.int64).reshape(nrg, NQUAL)
        ck = qk * ncyc + cyc[keep] + max_cycle
        self.cyc_obs = np.bincount(ck, minlength=nrg * NQUAL * ncyc).reshape(nrg, NQUAL, ncyc)
        self.cyc_err = np.bincount(ck, e, minlength=nrg * NQUAL * ncyc).astype(np.int64).reshape(
            nrg, NQUAL, ncyc)
        has = keep & (ctx >= 0)
        xk = (np.broadcast_to(rgi[:, None], bases.shape)[has] * NQUAL + quals[has]) * 16 + ctx[has]
        self.ctx_obs = np.bincount(xk, minlength=nrg * NQUAL * 16).reshape(nrg, NQUAL, 16)
        self.ctx_err = np.bincount(xk, err[has], minlength=nrg * NQUAL * 16).astype(np.int64).reshape(
            nrg, NQUAL, 16)
        self._finalize()

    def _finalize(self):
        dt = self.dtype
        quals = np.arange(NQUAL, dtype=np.float64)
        self.qs_eq = empirical_quality(self.qs_obs, self.qs_err,
                                       np.broadcast_to(quals, self.qs_obs.shape), dt).reshape(self.qs_obs.shape)
        self.combined = {}
        errp = np.power(dt(10), (quals / -10.0).astype(dt)).astype(dt)
        for i, rg in enumerate(self.rgs):
            obs = int(self.qs_obs[i].sum())
            if obs == 0:
                continue
            mism = int(self.qs_err[i].sum())
            s = np.sum(self.qs_obs[i].astype(dt) * errp, dtype=dt)
            reported = float(dt(-10) * np.log10(s / dt(obs)))
            self.combined[rg] = (reported, int(empirical_quality([obs], [mism], [reported], dt)[0]),
                                 obs, mism)

    def _eq(self, obs, err, prior):
        pres = obs > 0
        out = np.zeros(obs.shape, np.int64)
        if pres.any():
            out[pres] = empirical_quality(obs[pres], err[pres],
                                          np.broadcast_to(prior, obs.shape)[pres], self.dtype)
        return out, pres

    def report_rows(self) -> Dict[str, Dict[tuple, tuple]]:
        """The report's table rows as the writer prints them."""
        t0 = {(rg, "M"): ("%d.0000" % eq, "%.4f" % rep, str(obs), "%d.00" % mism)
              for rg, (rep, eq, obs, mism) in self.combined.items()}
        t1, t2 = {}, {}
        quals = np.arange(NQUAL, dtype=np.float64)
        eqc, _ = self._eq(self.cyc_obs, self.cyc_err, quals[None, :, None])
        eqx, _ = self._eq(self.ctx_obs, self.ctx_err, quals[None, :, None])
        for i, rg in enumerate(self.rgs):
            for q in np.flatnonzero(self.qs_obs[i]):
                t1[(rg, str(q), "M")] = ("%d.0000" % self.qs_eq[i, q], str(self.qs_obs[i, q]),
                                         "%d.00" % self.qs_err[i, q])
            for q, c in zip(*np.nonzero(self.cyc_obs[i])):
                t2[(rg, str(q), str(c - self.max_cycle), "Cycle", "M")] = (
                    "%d.0000" % eqc[i, q, c], str(self.cyc_obs[i, q, c]), "%d.00" % self.cyc_err[i, q, c])
            for q, c in zip(*np.nonzero(self.ctx_obs[i])):
                t2[(rg, str(q), "ACGT"[c // 4] + "ACGT"[c % 4], "Context", "M")] = (
                    "%d.0000" % eqx[i, q, c], str(self.ctx_obs[i, q, c]), "%d.00" % self.ctx_err[i, q, c])
        counts = np.zeros(NQUAL, np.int64)
        np.add.at(counts, self.qs_eq[self.qs_obs > 0], self.qs_obs[self.qs_obs > 0])
        quant = {(str(q),): (str(counts[q]),) for q in range(NQUAL)}
        return {"RecalTable0": t0, "RecalTable1": t1, "RecalTable2": t2, "Quantized": quant}

    def apply(self, r: Reads) -> List[bytes]:
        """Recalibrated qualities of every read (bqsr.go:901-1006), with
        --quantize-levels 0 and no static quantisation."""
        rg_eq = {rg: v[1] for rg, v in self.combined.items()}
        nrg = len(self.rgs)
        cond = np.zeros((nrg, NQUAL), np.int64)
        for i, rg in enumerate(self.rgs):
            base = rg_eq.get(rg, 0)
            eq, pres = self._eq(self.qs_obs[i], self.qs_err[i], np.full(NQUAL, float(base)))
            cond[i] = np.where(pres, eq, base)
        d_cyc, _ = self._eq(self.cyc_obs, self.cyc_err, cond[:, :, None].astype(np.float64))
        d_cyc = np.where(self.cyc_obs > 0, d_cyc - cond[:, :, None], 0)
        d_ctx, _ = self._eq(self.ctx_obs, self.ctx_err, cond[:, :, None].astype(np.float64))
        d_ctx = np.where(self.ctx_obs > 0, d_ctx - cond[:, :, None], 0)

        out = list(r.qual)
        rg_index = {rg: i for i, rg in enumerate(self.rgs)}
        rows = [i for i in range(len(r)) if self.pu.get(r.rg[i], r.rg[i]) in rg_eq]
        if not rows:
            return out
        w = max(len(r.seq[i]) for i in rows)
        bases = _padded([r.seq[i] for i in rows], w)
        quals = _padded([r.qual[i] for i in rows], w)
        n = np.array([len(r.seq[i]) for i in rows], np.int64)
        flag = np.array([r.flag[i] for i in rows], np.int64)
        ctx = _context(bases, quals, n, (flag & 0x10) != 0)
        # positions past a read's end are padding: keep their index in range
        cyc = np.clip(_cycles(n, flag, w) + self.max_cycle, 0, 2 * self.max_cycle)
        rgi = np.array([rg_index[self.pu.get(r.rg[i], r.rg[i])] for i in rows], np.int64)[:, None]
        q = quals.astype(np.int64)
        est = cond[rgi, q] + d_cyc[rgi, q, cyc] + np.where(ctx >= 0, d_ctx[rgi, q, np.maximum(ctx, 0)], 0)
        newq = np.clip(est, 1, MAX_RECALIBRATED_QUAL)
        newq = np.where(q < MIN_INTERESTING_QUAL, q, newq).astype(np.uint8)
        for j, i in enumerate(rows):
            out[i] = newq[j, : n[j]].tobytes()
        return out

