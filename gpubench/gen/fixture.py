"""Inputs of one cell, made from ``--seed``: a reference genome, a diploid
sample with planted SNPs, paired reads sampled from it, duplicates under
Illumina read names, and known sites.

The shapes are those of the port's earlier fixtures (tests/samgen.py's
``reads_from_genome``, chip_smoke.py's ``make_reference``,
``make_five_step_fixture``, ``make_long_read_fixture`` and
``realign_soft_clips``), rewritten in numpy so that a fixture of some
hundred thousand reads takes seconds, and with two changes: the sample is
diploid (a planted SNP is heterozygous on one haplotype or homozygous),
and a soft-clipped first mate is placed where its bases came from instead
of one clip length off (the fault that ``realign_soft_clips`` repaired).

A configuration with ``target_length``, ``target_gap`` and
``on_target_share`` describes a capture design (an exome): target
intervals along each contig, written as a BED, and that share of the
pairs drawn onto them; ``depth`` is then the mean coverage over the
targets. Without those keys nothing of the above changes, byte for byte.

A configuration with ``"qual_model": "hiseq2000"`` draws the raw base
qualities from ``hiseq2000_quals`` on a stream of their own; without the
key they are samgen's, uniform in 2-39, byte for byte as before.

The genome, the variants, the targets and the sampled reads come from
the configuration's own ``world_seed``, so that every seed gives the
same work; ``--seed`` draws the reads' order in the SAM and their
Illumina names (tiles and pixel coordinates), and with them which copy
of a duplicate set wins. The same seed gives the same bytes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
FIRST_FLAG = 0x1 | 0x2 | 0x40 | 0x20   # 99: paired, proper, first, mate reversed
SECOND_FLAG = 0x1 | 0x2 | 0x80 | 0x10  # 147: paired, proper, second, reversed
READ_GROUP = {"ID": "rg1", "LB": "lib1", "PL": "ILLUMINA", "PU": "unit1", "SM": "sample1"}


@dataclass
class Fixture:
    """What the generator made: the reference (``ref``, name -> uint8
    array), the planted SNPs as (contig, 0-based position, alt base,
    haplotypes carrying it: 1 = first, 2 = second, 3 = both), the
    hypervariable stretches (contig, first, last 0-based position), the
    known sites (contig, 0-based position), the read pairs as columns
    and the capture targets (contig, start, end: BED's 0-based half-open
    interval; none without a capture design)."""

    contigs: List[Tuple[str, int]]
    ref: Dict[str, np.ndarray]
    snps: List[Tuple[str, int, int, int]]
    stretches: List[Tuple[str, int, int]]
    known: List[Tuple[str, int]]
    pairs: Dict[str, np.ndarray] = field(default_factory=dict)
    targets: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def n_reads(self) -> int:
        return 2 * len(self.pairs["contig"])


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream per part of the fixture, so that a change in
    one part's draws leaves the others as they were."""
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


def make_genome(contigs, seed: int) -> Dict[str, np.ndarray]:
    """Random ACGT. No N: a real reference keeps its N in large gaps,
    which a cut of a few hundred kb leaves out (samgen's scattered N runs
    of 1-9 bases are a test of the parsers, not of a genome)."""
    rng = _rng(seed, 1)
    return {name: ACGT[rng.integers(0, 4, ln)] for name, ln in contigs}


def plant_variants(cfg: dict, ref: Dict[str, np.ndarray], seed: int):
    """SNPs about every ``snp_every`` bases (jittered by +-30 %), a
    ``het_share`` of them heterozygous (half on each haplotype) and the
    rest homozygous; with ``stretch_every``, a hypervariable stretch
    about that often: ``stretch_snps`` SNPs ``stretch_gap`` bases apart,
    spanning ``stretch_span`` bases, no other SNP within 500 bases of it;
    ``stretch_carriers`` gives, in turn along the stretch, the haplotypes
    that carry each of its SNPs (1 = first, 2 = second, 3 = both): [3],
    the default, is homozygous (chip_smoke.py's shape), [1, 2] two
    alleles that differ from each other at every SNP.
    Returns (haplotypes as {contig: uint8 [2, len]}, snps, stretches)."""
    rng = _rng(seed, 2)
    every = int(cfg["snp_every"])
    het = float(cfg["het_share"])
    haps, snps, stretches = {}, [], []
    for name, ln in cfg["contigs"]:
        r = ref[name]
        # one SNP per ``every`` bases, jittered by +-30 %; exactly
        # ``het_share`` of them heterozygous, so every seed has the same
        # number of each
        sites = [p + int(rng.integers(-3 * every // 10, 3 * every // 10))
                 for p in range(every // 2 + every // 5, ln - every // 2, every)]
        n_het = int(round(het * len(sites)))
        kinds = rng.permutation([1] * (n_het - n_het // 2) + [2] * (n_het // 2)
                                + [3] * (len(sites) - n_het))
        planted: Dict[int, int] = {p: int(k) for p, k in zip(sites, kinds)}
        se = int(cfg.get("stretch_every", 0))
        if se:
            lo_n, hi_n = cfg["stretch_snps"]
            lo_g, hi_g = cfg["stretch_gap"]
            lo_s, hi_s = cfg["stretch_span"]
            for k in range(se // 2, ln - 1000, se):
                first = k + int(rng.integers(-se // 8, se // 8))
                first = min(max(first, 2000), ln - 2000 - hi_s)  # where reads cover it fully
                gaps = np.zeros(0, np.int64)
                while not lo_s <= gaps.sum() <= hi_s:
                    gaps = rng.integers(lo_g, hi_g + 1, int(rng.integers(lo_n, hi_n + 1)) - 1)
                pos = first + np.concatenate([[0], np.cumsum(gaps)])
                for p in [p for p in planted if pos[0] - 500 <= p <= pos[-1] + 500]:
                    del planted[p]
                carriers = cfg.get("stretch_carriers", [3])
                for n, p in enumerate(pos):
                    planted[int(p)] = int(carriers[n % len(carriers)])
                stretches.append((name, int(pos[0]), int(pos[-1])))
        h = np.stack([r, r]).copy()
        for p in sorted(planted):
            if not 0 <= p < ln:
                continue
            alt = int(ACGT[(np.flatnonzero(ACGT == r[p])[0] + int(rng.integers(1, 4))) % 4])
            which = planted[p]
            if which & 1:
                h[0, p] = alt
            if which & 2:
                h[1, p] = alt
            snps.append((name, p, alt, which))
        haps[name] = h
    return haps, snps, stretches


def place_targets(cfg: dict, world: int) -> List[Tuple[str, int, int]]:
    """Capture targets along each contig: lengths uniform in
    ``target_length``, gaps uniform in ``target_gap`` (before the first
    one too), kept 3 x read length + 100 bases from either end of the
    contig, so that every pair drawn onto one fits on the contig.
    Sorted, apart from each other by at least the smallest gap."""
    rng = _rng(world, 8)
    lo_l, hi_l = cfg["target_length"]
    lo_g, hi_g = cfg["target_gap"]
    margin = 3 * int(cfg["read_length"]) + 100
    out = []
    for name, ln in cfg["contigs"]:
        at = margin + int(rng.integers(lo_g, hi_g + 1))
        while True:
            end = at + int(rng.integers(lo_l, hi_l + 1))
            if end > ln - margin:
                break
            out.append((name, at, end))
            at = end + int(rng.integers(lo_g, hi_g + 1))
    return out


def _on_target(rng, cfg: dict, targets, isize, clip):
    """(contig index, 1-based first-mate position) of pairs drawn onto
    the targets: a target base uniform over all target bases, and the
    pair placed so that one of its reads' aligned bases covers it (the
    first mate's after its clip, or the second mate's), uniformly."""
    rl = int(cfg["read_length"])
    index = {name: k for k, (name, _) in enumerate(cfg["contigs"])}
    t_ci = np.array([index[c] for c, _, _ in targets], np.int64)
    t_lo = np.array([s for _, s, _ in targets], np.int64)
    t_len = np.array([e - s for _, s, e in targets], np.int64)
    ends = np.cumsum(t_len)
    flat = rng.integers(0, ends[-1], len(isize))
    t = np.searchsorted(ends, flat, side="right")
    base = t_lo[t] + flat - (ends[t] - t_len[t]) + 1  # 1-based
    u = clip + (rng.random(len(isize)) * (2 * rl - clip)).astype(np.int64)
    # place_targets' margin keeps every such pair on its contig
    return t_ci[t], np.where(u < rl, base - u, base - (u - rl) - isize + rl)


def _target_bases(cfg: dict, targets, ci, pos, isize, clip) -> np.ndarray:
    """Each pair's aligned read bases that fall inside a target."""
    rl = int(cfg["read_length"])
    cum = {}
    for k, (name, ln) in enumerate(cfg["contigs"]):
        mask = np.zeros(ln + 1, np.int64)  # 1-based positions
        for c, s, e in targets:
            if c == name:
                mask[s + 1 : e + 1] = 1
        cum[k] = np.cumsum(mask)
    out = np.zeros(len(ci), np.int64)
    mpos = pos + isize - rl
    for k, cs in cum.items():
        at = ci == k
        for a, b in ((pos[at] + clip[at], pos[at] + rl - 1), (mpos[at], mpos[at] + rl - 1)):
            out[at] += cs[b] - cs[a - 1]
    return out


def capture_pairs(cfg: dict, targets, world: int) -> int:
    """The pairs of a capture design: enough drawn onto the targets for
    ``depth`` over the target bases, and those an ``on_target_share`` of
    all. The read bases that a pair drawn onto the targets lays on them
    are averaged over a calibration draw of 20 000 pairs."""
    rng = _rng(world, 10)
    rl, n = int(cfg["read_length"]), 20000
    isize = rng.integers(rl + 20, 2 * rl + 100, n)
    clip = np.where(rng.random(n) < 0.25, 5, 0)
    ci, pos = _on_target(rng, cfg, targets, isize, clip)
    per_pair = _target_bases(cfg, targets, ci, pos, isize, clip).mean()
    on = int(round(cfg["depth"] * sum(e - s for _, s, e in targets) / per_pair))
    return int(round(on / cfg["on_target_share"]))


def hiseq2000_quals(rng: np.random.Generator, n: int, rl: int) -> np.ndarray:
    """Raw base qualities of ``n`` reads of ``rl`` cycles in sequencing
    order (5' to 3'), shaped as a HiSeq 2000 run at 2x100 bp: a mean that
    falls linearly from Q38 at the first cycle to Q30 at the last, each
    base scattered about it by a normal of 3 and clipped to Q6-41, so
    that no base inside a read is Q2-5 and about 85 % of all bases are
    Q30 or above (Illumina's specification: at least 80 %). Three reads
    in ten end in a B-tail, Illumina's Read Segment Quality Control
    Indicator: Q2 over their last 1-20 cycles, contiguous."""
    cycles = np.arange(rl)
    mean = 38.0 - 8.0 * cycles / max(rl - 1, 1)
    q = np.clip(np.rint(mean + 3.0 * rng.standard_normal((n, rl))), 6, 41).astype(np.uint8)
    tail = np.where(rng.random(n) < 0.3, rng.integers(1, 21, n), 0)
    q[cycles[None, ::-1] < tail[:, None]] = 2
    return q


def sample_pairs(cfg: dict, haps: Dict[str, np.ndarray], world: int,
                 seed: int, targets=()) -> Dict[str, np.ndarray]:
    """``depth`` x genome / read length reads in pairs, each pair from one
    haplotype at a uniform position (contigs by length), insert sizes
    uniform in [read length + 20, 2 x read length + 100), one in four
    first mates soft-clipped by 5 bases, ``mismatch_rate`` random base
    changes, base qualities uniform in 2-39 with low-quality tails (0-2)
    on three reads in ten at each end, MAPQ uniform in 1-59 (samgen's
    distributions); with ``qual_model``, the qualities from that model
    instead (stream 11 of ``world``), independent of the base changes.
    Then ``dup_share`` of the pairs are duplicates: copies of sampled
    pairs, an ``optical_share`` of them on their original's tile within
    80 pixels. With ``targets``, the number of pairs is
    ``capture_pairs``'s and an ``on_target_share`` of the originals are
    drawn onto the targets (``_on_target``) instead. All of that comes
    from ``world``; the names and the order of the pairs come from
    ``seed``. Returns columns, pairs in the seed's order."""
    rng = _rng(world, 3)
    rl = int(cfg["read_length"])
    contigs = cfg["contigs"]
    total = sum(ln for _, ln in contigs)
    if targets:
        n_pairs = capture_pairs(cfg, targets, world)
    else:
        n_pairs = int(round(cfg["depth"] * total / rl / 2))
    n_dup = int(round(cfg["dup_share"] * n_pairs))
    n_orig = n_pairs - n_dup

    lens = np.array([ln for _, ln in contigs], np.int64)
    ci = rng.choice(len(contigs), n_orig, p=lens / lens.sum())
    pos = (rng.random(n_orig) * (lens[ci] - 3 * rl - 1)).astype(np.int64) + 1  # 1-based
    hap = rng.integers(0, 2, n_orig)
    isize = rng.integers(rl + 20, 2 * rl + 100, n_orig)
    clip = np.where(rng.random(n_orig) < 0.25, 5, 0)
    if targets:
        n_on = int(round(cfg["on_target_share"] * n_orig))
        ci, pos = ci.copy(), pos.copy()
        ci[:n_on], pos[:n_on] = _on_target(_rng(world, 9), cfg, targets, isize[:n_on],
                                           clip[:n_on])
    mpos = pos + isize - rl

    offs = np.concatenate([[0], np.cumsum(lens)])
    flat = np.concatenate([haps[name] for name, _ in contigs], axis=1)  # [2, total]
    cols = np.arange(rl)

    def bases(start):
        seq = flat[hap[:, None], offs[ci][:, None] + start[:, None] - 1 + cols[None, :]]
        change = rng.random(seq.shape) < cfg["mismatch_rate"]
        return np.where(change, ACGT[rng.integers(0, 4, seq.shape)], seq).astype(np.uint8)

    def quals():
        q = rng.integers(2, 40, (n_orig, rl)).astype(np.uint8)
        for end in (0, 1):
            tail = np.where(rng.random(n_orig) < 0.3, rng.integers(1, 5, n_orig), 0)
            low = rng.integers(0, 3, (n_orig, rl)).astype(np.uint8)
            at = (cols[None, ::-1] if end else cols[None, :]) < tail[:, None]
            q = np.where(at, low, q)
        return q

    seq1, seq2 = bases(pos), bases(mpos)
    # drawn with or without a quality model, so that what follows on this
    # stream (MAPQ, the duplicates) comes from the same draws either way
    qual1, qual2 = quals(), quals()
    model = cfg.get("qual_model")
    if model is not None:
        if model != "hiseq2000":
            raise ValueError("unknown qual_model %r (known: hiseq2000)" % model)
        qrng = _rng(world, 11)
        qual1 = hiseq2000_quals(qrng, n_orig, rl)
        # the second mate is reversed: the SAM holds its 3' end first
        qual2 = hiseq2000_quals(qrng, n_orig, rl)[:, ::-1]
    mapq = rng.integers(1, 60, n_orig)

    src = rng.integers(0, n_orig, n_dup)
    optical = rng.random(n_dup) < cfg["optical_share"]

    # Illumina read names HWI-ST1234:8:FLOWCELL:lane:tile:x:y, all distinct
    rng = _rng(seed, 6)
    lane = rng.integers(1, 9, n_orig)
    tile = rng.choice(np.array([s * 1000 + sw * 100 + t for s in (1, 2) for sw in (1, 2, 3)
                                for t in range(1, 17)]), n_orig)
    x = rng.integers(1000, 21000, n_orig)
    y = rng.integers(1000, 200000, n_orig)
    key = ((lane * 10000 + tile) * 100000 + x) * 1000000 + y
    _, first = np.unique(key, return_index=True)
    keep = np.zeros(n_orig, bool)
    keep[first] = True
    y = np.where(keep, y, 200000 + np.arange(n_orig))  # a collision moves off the grid

    # duplicates: copies of sampled originals under their own names
    d_lane = np.where(optical, lane[src], rng.integers(1, 9, n_dup))
    d_tile = np.where(optical, tile[src], rng.choice(tile, n_dup))
    # within 80 pixels of the original, never on it (a copy keeps a name of its own)
    dx = rng.integers(1, 81, n_dup) * rng.choice([-1, 1], n_dup)
    dy = rng.integers(-80, 81, n_dup)
    d_x = np.where(optical, x[src] + dx, rng.integers(1000, 21000, n_dup))
    d_y = np.where(optical, y[src] + dy, 400000 + np.arange(n_dup))

    def with_copies(col):
        return np.concatenate([col, col[src]])

    pairs = {k: with_copies(v) for k, v in (
        ("contig", ci), ("pos", pos), ("mpos", mpos), ("clip", clip), ("mapq", mapq),
        ("seq1", seq1), ("seq2", seq2), ("qual1", qual1), ("qual2", qual2))}
    pairs.update(lane=np.concatenate([lane, d_lane]), tile=np.concatenate([tile, d_tile]),
                 x=np.concatenate([x, d_x]), y=np.concatenate([y, d_y]))
    order = _rng(seed, 7).permutation(n_pairs)
    return {k: v[order] for k, v in pairs.items()}


def make_fixture(cfg: dict, seed: int) -> Fixture:
    contigs = [(str(n), int(ln)) for n, ln in cfg["contigs"]]
    cfg = dict(cfg, contigs=contigs)
    world = int(cfg["world_seed"])
    ref = make_genome(contigs, world)
    haps, snps, stretches = plant_variants(cfg, ref, world)
    rng = _rng(world, 4)
    known = [(c, p) for c, p, _, _ in snps if rng.random() < cfg["known_share"]]
    targets = place_targets(cfg, world) if "on_target_share" in cfg else []
    if "on_target_share" in cfg and not targets:
        raise ValueError("the contigs are too short to hold a target")
    return Fixture(contigs, ref, snps, stretches, known,
                   sample_pairs(cfg, haps, world, seed, targets), targets)


def sam_lines(fx: Fixture, rows=None) -> List[str]:
    """The SAM records of the pairs ``rows`` (all by default), two per pair."""
    p = fx.pairs
    names = [c for c, _ in fx.contigs]
    rl = p["seq1"].shape[1]
    rows = np.arange(len(p["contig"])) if rows is None else rows
    out = []
    for i in rows:
        qn = "HWI-ST1234:8:C0ABCACXX:%d:%d:%d:%d" % (p["lane"][i], p["tile"][i],
                                                   p["x"][i], p["y"][i])
        c = names[p["contig"][i]]
        clip = int(p["clip"][i])
        pos1 = int(p["pos"][i]) + clip
        mpos = int(p["mpos"][i])
        tlen = mpos + rl - pos1
        cig1 = "%dS%dM" % (clip, rl - clip) if clip else "%dM" % rl
        mq = int(p["mapq"][i])
        out.append("%s\t%d\t%s\t%d\t%d\t%s\t=\t%d\t%d\t%s\t%s\tRG:Z:rg1" % (
            qn, FIRST_FLAG, c, pos1, mq, cig1, mpos, tlen, p["seq1"][i].tobytes().decode(),
            (p["qual1"][i] + 33).tobytes().decode()))
        out.append("%s\t%d\t%s\t%d\t%d\t%dM\t=\t%d\t%d\t%s\t%s\tRG:Z:rg1" % (
            qn, SECOND_FLAG, c, mpos, mq, rl, pos1, -tlen, p["seq2"][i].tobytes().decode(),
            (p["qual2"][i] + 33).tobytes().decode()))
    return out


def header_lines(fx: Fixture) -> List[str]:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    lines += ["@SQ\tSN:%s\tLN:%d" % (n, ln) for n, ln in fx.contigs]
    lines.append("@RG\t" + "\t".join("%s:%s" % kv for kv in READ_GROUP.items()))
    return lines


def write_inputs(fx: Fixture, workdir: str, tag: str, rows=None) -> Dict[str, str]:
    """FASTA, known-sites BED and SAM (the pairs ``rows``, all by default)
    under ``workdir``, and the capture targets as a BED where there are
    any. Returns their paths (the targets' under ``targets``)."""
    os.makedirs(workdir, exist_ok=True)
    paths = {k: os.path.join(workdir, "%s.%s" % (tag, k)) for k in ("fasta", "bed", "sam")}
    if fx.targets:
        paths["targets"] = os.path.join(workdir, tag + ".targets.bed")
        with open(paths["targets"], "w") as fh:
            fh.writelines("%s\t%d\t%d\n" % t for t in fx.targets)
    with open(paths["fasta"], "w") as fh:
        for name, _ in fx.contigs:
            s = fx.ref[name].tobytes().decode()
            fh.write(">%s\n" % name)
            fh.write("\n".join(s[k : k + 70] for k in range(0, len(s), 70)) + "\n")
    with open(paths["bed"], "w") as fh:
        fh.writelines("%s\t%d\t%d\n" % (c, p, p + 1) for c, p in fx.known)
    with open(paths["sam"], "w") as fh:
        fh.write("\n".join(header_lines(fx) + sam_lines(fx, rows)) + "\n")
    return paths
