"""The comparison that decides ``correct``: the reference worked out once
from the inputs the benchmark made (FASTA, known-sites BED, SAM), then
each judged job's output files held against it, number by number.

Nothing here imports the program or JAX; it reads the program's output
files only to judge them."""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

from . import bqsr, gvcf, markdup, records, targets

# every number compared; its limit is 0 unless the configuration names another
NUMBERS = ("records_unmatched", "records_altered", "dup_flag_mismatches", "order_mismatches",
         "metrics_mismatches", "recal_row_mismatches", "qual_mismatches",
         "gvcf_tiling_errors", "gvcf_ref_mismatches", "gvcf_discordant_pct")


def numbers_for(outputs) -> List[str]:
    """The numbers compared for a job that writes ``outputs``."""
    return [n for n in NUMBERS if (not n.startswith("gvcf_") or "gvcf" in outputs)
            and (n != "recal_row_mismatches" or "recal" in outputs)]


class Expected:
    """The reference's answers for one cell's inputs. ``paths`` holds the
    benchmark's own ``fasta``, ``bed`` and ``sam``; ``outputs`` names the
    files a job writes (``bam``, ``metrics``, ``recal``, ``gvcf``);
    ``planted`` the planted SNPs as (contig, 0-based position);
    ``target_regions`` the BED that a job passes to ``--target-regions``,
    or None.

    With target regions, where the port and the JAX package apply
    elPrep's filter: duplicates and their metrics over every read, then
    the reads that overlap no target left out (reference/targets.py)
    before BQSR, so that the records written, their order, the BQSR
    tables and qualities and the pileup are those of the kept reads;
    the GVCF covers the calling spans (``spans``, None for whole
    contigs)."""

    def __init__(self, paths: Dict[str, str], outputs: List[str], planted: List[tuple],
                 target_regions: Optional[str] = None):
        self.outputs = outputs
        self.header, r = records.read_sam(paths["sam"])
        self.contigs = []
        for ln in self.header:
            if ln.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in ln.split("\t")[1:])
                self.contigs.append((d["SN"], int(d["LN"])))
        alns = markdup.alignments(self.header, r)
        dup, groups = markdup.mark_duplicates(alns)
        self.metrics = markdup.duplication_metrics(alns, dup, groups)
        order = markdup.coordinate_order(alns)
        self.spans = None
        if target_regions:
            bed = targets.read_bed(target_regions)
            keep = targets.kept(r, bed)
            self.spans = targets.spans(bed)
            self.order = [r.identity(i) for i in order if keep[i]]
            rows = [i for i in range(len(r)) if keep[i]]
            r, dup = r.select(rows), [dup[i] for i in rows]
        else:
            self.order = [r.identity(i) for i in order]
        self.reads, self.dup = r, dup
        self.index = {r.identity(i): i for i in range(len(r))}
        self.genome = records.read_fasta(paths["fasta"])
        self.quals = list(r.qual)
        if "recal" in outputs:
            rc = bqsr.Recalibration(self.header, r, self.dup, self.genome,
                                    records.read_known_sites(paths["bed"]))
            self.recal = rc.report_rows()
            self.quals = rc.apply(r)
        if "gvcf" in outputs:
            self.counts = gvcf.pileup(r, self.dup, self.quals, dict(self.contigs))
            self.planted = [(c, p) for c, p in planted]


def _metrics_mismatches(want: Dict[str, Dict[str, float]], path: str) -> int:
    got = records.read_metrics(path)
    bad = 0
    for lib, row in want.items():
        have = got.get(lib)
        if have is None:
            bad += len(row)
            continue
        for col, v in row.items():
            text = have.get(col)
            if text is None:
                bad += 1
            elif col == "PERCENT_DUPLICATION":
                bad += not (math.isnan(v) and text == "NaN"
                            or text != "NaN" and abs(float(text) - v) <= 5e-7)
            else:
                bad += int(text) != v
    # a library with examined reads that the reference does not know
    bad += sum(1 for lib, row in got.items() if lib not in want
               and any(row.get(c, "0") not in ("0", "NaN") for c in row))
    return bad


def recal_row_mismatches(want: Dict[str, Dict[tuple, tuple]],
                         got: Dict[str, Dict[tuple, tuple]]) -> int:
    """Rows of the recal report's tables that differ or are missing on
    either side; of the Quantized table only the count is compared (apply
    runs with --quantize-levels 0)."""
    bad = 0
    for name, rows in want.items():
        have = got.get(name, {})
        for key in set(rows) | set(have):
            a, b = rows.get(key), have.get(key)
            if name == "Quantized":
                a, b = a and a[:1], b and b[:1]
            bad += a != b
    return bad


def judge(exp: Expected, out: Dict[str, str], notes: list = None) -> Dict[str, int]:
    """The numbers of one job's outputs ``out`` (paths by kind); what
    disagrees is described in ``notes``, where given."""
    r = exp.reads
    n = {k: 0 for k in numbers_for(exp.outputs)}
    _, _, b = records.read_bam(out["bam"])
    seen = set()
    for j in range(len(b)):
        ident = b.identity(j)
        i = exp.index.get(ident)
        if i is None or ident in seen:
            n["records_unmatched"] += 1
            continue
        seen.add(ident)
        if ((b.flag[j] & ~0x400) != (r.flag[i] & ~0x400) or b.rname[j] != r.rname[i]
                or b.pos[j] != r.pos[i] or b.mapq[j] != r.mapq[i] or b.cigar[j] != r.cigar[i]
                or b.rnext[j] != r.rnext[i] or b.pnext[j] != r.pnext[i] or b.tlen[j] != r.tlen[i]
                or b.seq[j] != r.seq[i] or b.rg[j] != r.rg[i]):
            n["records_altered"] += 1
        n["dup_flag_mismatches"] += bool(b.flag[j] & 0x400) != exp.dup[i]
        n["qual_mismatches"] += b.qual[j] != exp.quals[i]
    n["records_unmatched"] += len(r) - len(seen)
    got_order = [b.identity(j) for j in range(len(b))]
    n["order_mismatches"] = sum(x != y for x, y in zip(got_order, exp.order)) + abs(
        len(got_order) - len(exp.order))
    n["metrics_mismatches"] = _metrics_mismatches(exp.metrics, out["metrics"])
    if "recal" in exp.outputs:
        n["recal_row_mismatches"] = recal_row_mismatches(exp.recal,
                                                         records.read_recal_report(out["recal"]))
    if "gvcf" in exp.outputs:
        _, recs = records.read_gvcf(out["gvcf"])
        n.update(gvcf.check(recs, exp.contigs, exp.genome, exp.counts, exp.planted, notes,
                            exp.spans))
    return n


def judge_files(exp: Expected, out: Dict[str, str], notes: list = None):
    """(numbers, None) of judge(), or (None, why) for a job whose outputs
    are missing or cannot be read: such a job has failed."""
    missing = [out[k] for k in exp.outputs if not os.path.exists(out[k])]
    if missing:
        return None, "missing " + ", ".join(missing)
    try:
        return judge(exp, out, notes), None
    except (OSError, ValueError, KeyError, IndexError, EOFError, UnicodeDecodeError) as e:
        return None, "unreadable: %s" % str(e)[:200]
