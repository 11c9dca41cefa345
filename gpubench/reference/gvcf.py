"""What a GVCF must say about the benchmark's reads, worked out from the
reads themselves: a plain pileup genotyper of single-base variants, and
the tiling of every contig by the records.

The HaplotypeCaller's likelihoods, qualities and annotations are not
recomputed here: a plain HaplotypeCaller is out of reach. The GVCF is
held to what any germline caller's output must say on these reads: that
every reference base is covered once, with the reference's own base,
that at few of the sites where the reads are clear (a planted SNP, or
any call) the genotype differs from the one they show. The
HaplotypeCaller leaves some clear heterozygous sites uncalled (its active
regions and assembly decide, in the JAX package as in the port), so that
share has a limit of its own, set from readings."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

from .records import Reads

MIN_MAPQ = 20        # the HaplotypeCaller's read filter
MIN_BASE_QUAL = 10   # bases at or below Q10 do not count for it either
MIN_DEPTH = 10
HOM_REF_BELOW = 0.1  # alt share of a clear homozygous reference site
HET = (0.25, 0.75)   # alt share of a clear heterozygous site
HOM_ALT_FROM = 0.9   # alt share of a clear homozygous alt site
ACGT = b"ACGT"


def pileup(r: Reads, dup: List[bool], quals: List[bytes],
           lengths: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Counts of A, C, G, T per reference position ([len, 4] per contig)
    over the aligned bases of non-duplicate primary reads with MAPQ >= 20
    and base quality > 10, reads of M and soft clips only."""
    out = {c: np.zeros((n, 4), np.int64) for c, n in lengths.items()}
    code = np.full(256, -1, np.int64)
    for k, b in enumerate(ACGT):
        code[b] = k
    by: Dict[str, list] = {c: [[], []] for c in lengths}
    for i in range(len(r)):
        if dup[i] or r.flag[i] & 0xF04 or r.mapq[i] < MIN_MAPQ or r.rname[i] not in lengths:
            continue
        cig = r.cigar[i]
        lo = cig[0][0] if cig and cig[0][1] == "S" else 0
        hi = len(r.seq[i]) - (cig[-1][0] if len(cig) > 1 and cig[-1][1] == "S" else 0)
        if any(op not in "MS" for _, op in cig):
            raise ValueError("the pileup handles M and S only, not %r" % (cig,))
        s = np.frombuffer(r.seq[i][lo:hi], np.uint8)
        q = np.frombuffer(quals[i][lo:hi], np.uint8)
        pos = r.pos[i] - 1 + np.arange(hi - lo)
        keep = (q > MIN_BASE_QUAL) & (code[s] >= 0) & (pos < lengths[r.rname[i]])
        by[r.rname[i]][0].append(pos[keep])
        by[r.rname[i]][1].append(code[s[keep]])
    for c, (pos, base) in by.items():
        if pos:
            np.add.at(out[c], (np.concatenate(pos), np.concatenate(base)), 1)
    return out


def expected_genotype(counts: np.ndarray, ref_base: int) -> Tuple[str, int]:
    """(genotype, alt base) the reads show at one position, or ("", -1)
    where they are not clear (too shallow, or an alt share between the
    bands)."""
    d = int(counts.sum())
    if d < MIN_DEPTH or ref_base not in ACGT:
        return "", -1
    ri = ACGT.index(ref_base)
    alt = [k for k in range(4) if k != ri]
    a = max(alt, key=lambda k: counts[k])
    share = counts[a] / d
    if share < HOM_REF_BELOW:
        return "0/0", -1
    if HET[0] <= share <= HET[1]:
        return "0/1", ACGT[a]
    if share >= HOM_ALT_FROM:
        return "1/1", ACGT[a]
    return "", -1


def check(records: List[List[str]], contigs: List[Tuple[str, int]],
          genome: Dict[str, np.ndarray], counts: Dict[str, np.ndarray],
          planted: List[Tuple[str, int]], notes: list = None,
          spans: Optional[Dict[str, List[Tuple[int, int]]]] = None) -> Dict[str, int]:
    """The GVCF's numbers: positions of a calling span left out or
    covered out of order, and records outside every span (tiling);
    records whose REF does not start with the reference's base; and the
    share of the judged sites (each planted SNP where the reads clearly
    show a variant, and each call where the reads are clear) at which
    the GVCF does not give the genotype and allele the reads show. The
    calling spans are ``spans`` ({contig: [(first, last)]}, 1-based and
    sorted), or every contig whole; only sites inside them are judged.
    Each site judged wrong is described in ``notes``, where given."""
    if spans is None:
        spans = {c: [(1, n)] for c, n in contigs}
    order = {c: k for k, (c, _) in enumerate(contigs)}
    firsts = {c: [lo for lo, _ in spans.get(c, [])] for c, _ in contigs}

    def span_at(c, pos):  # the index of the span that holds a 1-based position, or -1
        k = bisect.bisect_right(firsts.get(c, []), pos) - 1
        return k if k >= 0 and pos <= spans[c][k][1] else -1

    tiling = ref_bad = 0
    calls: Dict[Tuple[str, int], Tuple[str, str, str]] = {}
    # per span, the last position covered so far
    covered = {c: [lo - 1 for lo, _ in spans.get(c, [])] for c, _ in contigs}
    last = (-1, 0)
    for f in records:
        c, pos, ref, alt = f[0], int(f[1]), f[3], f[4]
        if c not in order:
            tiling += 1
            continue
        if (order[c], pos) <= last:
            tiling += 1
        last = (order[c], pos)
        end = pos + len(ref) - 1
        for kv in f[7].split(";"):
            if kv.startswith("END="):
                end = int(kv[4:])
        k = span_at(c, pos)
        if k < 0:
            tiling += 1  # outside every calling span
            continue
        if pos > covered[c][k] + 1:
            tiling += 1
        covered[c][k] = max(covered[c][k], end)
        g = genome[c]
        if not 1 <= pos <= len(g) or ref[:1].upper() != chr(g[pos - 1]):
            ref_bad += 1
        gt = f[9].split(":")[0].replace("|", "/")
        alts = [a for a in alt.split(",") if a != "<NON_REF>"]
        if alts and gt not in ("0/0", "./."):
            calls[(c, pos - 1)] = (gt, ref, alts[int(max(gt.split("/"))) - 1])
    tiling += sum(cov != hi for c in covered for cov, (_, hi) in zip(covered[c], spans.get(c, [])))
    # the sites judged: each planted SNP where the reads clearly show a
    # variant, and each call where the reads are clear
    planted_set = {(c, p) for c, p in planted if span_at(c, p + 1) >= 0}
    judged = bad = 0
    for c, p in sorted(set(calls) | planted_set):
        want, wbase = expected_genotype(counts[c][p], int(genome[c][p]))
        got = calls.get((c, p))
        if not want or (got is None and (want == "0/0" or (c, p) not in planted_set)):
            continue
        judged += 1
        if got is None:
            why = "uncalled"
        elif len(got[1]) != 1 or len(got[2]) != 1:
            why = "an indel where the reads show none"
        else:
            a, b = sorted(got[0].split("/"))
            norm = "0/1" if a == "0" and b != "0" else "1/1"
            why = "" if norm == want and ord(got[2]) == wbase else "called %s" % "/".join(got)
        if why:
            bad += 1
            if notes is not None:
                notes.append("%s:%d: reads %s%s (ACGT %s), gvcf %s" % (
                    c, p + 1, want, " " + chr(wbase) if wbase > 0 else "",
                    ",".join(map(str, counts[c][p])), why))
    return {"gvcf_tiling_errors": tiling, "gvcf_ref_mismatches": ref_bad,
            "gvcf_discordant_pct": 100.0 * bad / judged if judged else 0.0}
