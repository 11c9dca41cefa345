"""GATK-compatible BQSR recalibration report
(reference: filters/print-bqsr.go, 329 LoC).

Byte-level replication of elPrep's `#:GATKReport.v1.1:5` writer,
including column-width computation and sort orders. The intermediate
form for sfm-style merging is .npz dense tables instead of Go gob
(LoadAndCombineBQSRTables, print-bqsr.go:309-329).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from .bqsr import NCTX, NQUAL, QUANTIZATION_LEVEL, BaseRecalibratorTables

TABLENAME_PREFIX = "GATK"  # --bqsr-tablename-prefix default (cmd/filter.go:481)

# exact literals incl. trailing padding (print-bqsr.go:275-292)
_ARGUMENTS_ROWS = [
    ("Argument", "Value"),
    ("binary_tag_name", "null"),
    ("covariate", "ReadGroupCovariate,QualityScoreCovariate,ContextCovariate,CycleCovariate"),
    ("default_platform", "null"),
    ("deletions_default_quality", "45"),
    ("force_platform", "null"),
    ("indels_context_size", "3"),
    ("insertions_default_quality", "45"),
    ("low_quality_tail", "2"),
    ("maximum_cycle_value", "500"),
    ("mismatches_context_size", "2"),
    ("mismatches_default_quality", "-1"),
    ("no_standard_covs", "false"),
    ("quantizing_levels", "16"),
    ("recalibration_report", "null"),
    ("run_without_dbsnp", "false"),
    ("solid_nocall_strategy", "THROW_EXCEPTION"),
    ("solid_recal_mode", "SET_Q_ZERO"),
]
_ARGUMENTS_TABLE = "".join(f"{k:<28}{v:<72}\n" for k, v in _ARGUMENTS_ROWS)


def _ctx_text(idx: int) -> str:
    """2-mer context string for dense index b1*4+b2
    (matches keyToString, reference: bqsr.go:166-178)."""
    return "ACGT"[idx // 4] + "ACGT"[idx % 4]


def print_bqsr_tables(tables: BaseRecalibratorTables, path: str, prefix: str = TABLENAME_PREFIX) -> None:
    """(reference: print-bqsr.go:269-298)"""
    if tables.qs_eq is None:
        tables.finalize()
    out = []
    out.append(f"#:{prefix}Report.v1.1:5\n")
    out.append(f"#:{prefix}Table:2:17:%s:%s:;\n")
    out.append(f"#:{prefix}Table:Arguments:Recalibration argument collection values used in this run\n")
    out.append(_ARGUMENTS_TABLE)
    out.append("\n")
    out.append(_quantization_table(tables, prefix))
    out.append(_combined_table(tables, prefix))
    out.append(_recal_table1(tables, prefix))
    out.append(_recal_table2(tables, prefix))
    with open(path, "w") as f:
        f.write("".join(out))


def _quantization_table(tables: BaseRecalibratorTables, prefix: str) -> str:
    """(reference: print-bqsr.go:49-76)"""
    observations, scores = tables.quantization(QUANTIZATION_LEVEL)
    lines = []
    lines.append(f"#:{prefix}Table:3:{len(observations)}:%d:%d:%d:;\n")
    lines.append(f"#:{prefix}Table:Quantized:Quality quantization map\n")
    w_q = max(len("QualityScore"), *(len(str(i)) for i in range(len(observations))))
    w_c = max(len("Count"), *(len(str(int(o))) for o in observations))
    w_s = max(len("QuantizedScore"), *(len(str(int(s))) for s in scores))
    lines.append(f"{'QualityScore':<{w_q}}  {'Count':<{w_c}}  {'QuantizedScore':<{w_s}}\n")
    for i, obs in enumerate(observations):
        lines.append(f"{i:>{w_q}}  {int(obs):>{w_c}}  {int(scores[i]):>{w_s}}\n")
    lines.append("\n")
    return "".join(lines)


def _combined_table(tables: BaseRecalibratorTables, prefix: str) -> str:
    """(reference: print-bqsr.go:78-122)"""
    table = tables.combined_rg_table()
    lines = []
    lines.append(f"#:{prefix}Table:6:{len(table)}:%s:%s:%.4f:%.4f:%d:%.2f:;\n")
    lines.append(f"#:{prefix}Table:RecalTable0:\n")
    w_rg = len("ReadGroup")
    w_et = len("EventType")
    w_eq = len("EmpiricalQuality")
    w_rep = len("EstimatedQReported")
    w_obs = len("Observations")
    w_err = len("Errors")
    for rg, (reported, eq, obs, mism) in table.items():
        w_rg = max(w_rg, len(rg))
        w_eq = max(w_eq, len(str(eq)) + 5)
        w_rep = max(w_rep, len(f"{reported:.4f}"))
        w_obs = max(w_obs, len(str(obs)))
        w_err = max(w_err, len(str(mism)) + 3)
    lines.append(
        f"{'ReadGroup':<{w_rg}}  {'EventType':<{w_et}}  {'EmpiricalQuality':<{w_eq}}"
        f"  {'EstimatedQReported':<{w_rep}}  {'Observations':<{w_obs}}  {'Errors':<{w_err}}\n"
    )
    for rg in sorted(table.keys()):
        reported, eq, obs, mism = table[rg]
        lines.append(
            f"{rg:<{w_rg}}  {'M':<{w_et}}  {eq:>{w_eq - 5}}.0000"
            f"  {reported:>{w_rep}.4f}  {obs:>{w_obs}}  {mism:>{w_err - 3}}.00\n"
        )
    lines.append("\n")
    return "".join(lines)


def _recal_table1(tables: BaseRecalibratorTables, prefix: str) -> str:
    """(reference: print-bqsr.go:124-175)"""
    entries: List[Tuple[str, int, int, int, int]] = []
    for i, rg in enumerate(tables.rg_names):
        for q in range(NQUAL):
            obs = int(tables.qs_obs[i, q])
            if obs > 0:
                entries.append((rg, q, int(tables.qs_eq[i, q]), obs, int(tables.qs_mism[i, q])))
    lines = []
    lines.append(f"#:{prefix}Table:6:{len(entries)}:%s:%d:%s:%.4f:%d:%.2f:;\n")
    lines.append(f"#:{prefix}Table:RecalTable1:\n")
    w_rg = len("ReadGroup")
    w_q = len("QualityScore")
    w_et = len("EventType")
    w_eq = len("EmpiricalQuality")
    w_obs = len("Observations")
    w_err = len("Errors")
    for rg, q, eq, obs, mism in entries:
        w_rg = max(w_rg, len(rg))
        w_q = max(w_q, len(str(q)))
        w_eq = max(w_eq, len(str(eq)) + 5)
        w_obs = max(w_obs, len(str(obs)))
        w_err = max(w_err, len(str(mism)) + 3)
    lines.append(
        f"{'ReadGroup':<{w_rg}}  {'QualityScore':<{w_q}}  {'EventType':<{w_et}}"
        f"  {'EmpiricalQuality':<{w_eq}}  {'Observations':<{w_obs}}  {'Errors':<{w_err}}\n"
    )
    entries.sort(key=lambda e: (e[0], e[1]))
    for rg, q, eq, obs, mism in entries:
        lines.append(
            f"{rg:<{w_rg}}  {q:>{w_q}}  {'M':<{w_et}}  {eq:>{w_eq - 5}}.0000"
            f"  {obs:>{w_obs}}  {mism:>{w_err - 3}}.00\n"
        )
    lines.append("\n")
    return "".join(lines)


def _recal_table2(tables: BaseRecalibratorTables, prefix: str) -> str:
    """(reference: print-bqsr.go:183-266)"""
    quals = np.arange(NQUAL, dtype=np.float64)
    # finalized EQ for cycles/contexts uses prior = Qual (bqsr.go:684-692)
    from .bqsr import _entry_empirical_quality

    entries: List[Tuple[str, int, str, str, int, int, int]] = []
    cyc_pres = tables.cyc_obs > 0
    if cyc_pres.any():
        eq_cyc = np.zeros(tables.cyc_obs.shape, np.uint8)
        pr = np.broadcast_to(quals[None, :, None], tables.cyc_obs.shape)
        eq_cyc[cyc_pres] = _entry_empirical_quality(
            tables.cyc_obs[cyc_pres], tables.cyc_mism[cyc_pres], pr[cyc_pres]
        )
        for i, q, c in zip(*np.nonzero(cyc_pres)):
            rg = tables.rg_names[i]
            text = str(int(c) - tables.max_cycle)
            entries.append(
                (rg, int(q), text, "Cycle", int(eq_cyc[i, q, c]),
                 int(tables.cyc_obs[i, q, c]), int(tables.cyc_mism[i, q, c]))
            )
    ctx_pres = tables.ctx_obs > 0
    if ctx_pres.any():
        eq_ctx = np.zeros(tables.ctx_obs.shape, np.uint8)
        pr = np.broadcast_to(quals[None, :, None], tables.ctx_obs.shape)
        eq_ctx[ctx_pres] = _entry_empirical_quality(
            tables.ctx_obs[ctx_pres], tables.ctx_mism[ctx_pres], pr[ctx_pres]
        )
        for i, q, c in zip(*np.nonzero(ctx_pres)):
            rg = tables.rg_names[i]
            entries.append(
                (rg, int(q), _ctx_text(int(c)), "Context", int(eq_ctx[i, q, c]),
                 int(tables.ctx_obs[i, q, c]), int(tables.ctx_mism[i, q, c]))
            )
    lines = []
    lines.append(f"#:{prefix}Table:8:{len(entries)}:%s:%d:%s:%s:%s:%.4f:%d:%.2f:;\n")
    lines.append(f"#:{prefix}Table:RecalTable2:\n")
    w_rg = len("ReadGroup")
    w_q = len("QualityScore")
    w_cv = len("CovariateValue")
    w_cn = max(len("CovariateName"), len("Cycle"), len("Context"))
    w_et = len("EventType")
    w_eq = len("EmpiricalQuality")
    w_obs = len("Observations")
    w_err = len("Errors")
    for rg, q, text, name, eq, obs, mism in entries:
        w_rg = max(w_rg, len(rg))
        w_q = max(w_q, len(str(q)))
        w_cv = max(w_cv, len(text))
        w_eq = max(w_eq, len(str(eq)) + 5)
        w_obs = max(w_obs, len(str(obs)))
        w_err = max(w_err, len(str(mism)) + 3)
    lines.append(
        f"{'ReadGroup':<{w_rg}}  {'QualityScore':<{w_q}}  {'CovariateValue':<{w_cv}}"
        f"  {'CovariateName':<{w_cn}}  {'EventType':<{w_et}}  {'EmpiricalQuality':<{w_eq}}"
        f"  {'Observations':<{w_obs}}  {'Errors':<{w_err}}\n"
    )
    entries.sort(key=lambda e: (e[0], e[1], e[2]))
    for rg, q, text, name, eq, obs, mism in entries:
        lines.append(
            f"{rg:<{w_rg}}  {q:>{w_q}}  {text:<{w_cv}}  {name:<{w_cn}}  {'M':<{w_et}}"
            f"  {eq:>{w_eq - 5}}.0000  {obs:>{w_obs}}  {mism:>{w_err - 3}}.00\n"
        )
    lines.append("\n")
    return "".join(lines)


# ---------------------------------------------------------------------------
# Intermediate (sfm) form: dense tables as .npz
# (reference uses gob files, print-bqsr.go:301-329)
# ---------------------------------------------------------------------------


def save_intermediate(tables: BaseRecalibratorTables, path: str) -> None:
    # write via a file object so the exact path is honored (np.savez
    # would append .npz to a bare path like foo.elrecal)
    with open(path, "wb") as f:
        np.savez_compressed(
            f,
            rg_names=np.array(tables.rg_names),
            max_cycle=np.array(tables.max_cycle),
            qs_obs=tables.qs_obs, qs_mism=tables.qs_mism,
            cyc_obs=tables.cyc_obs, cyc_mism=tables.cyc_mism,
            ctx_obs=tables.ctx_obs, ctx_mism=tables.ctx_mism,
        )


def load_intermediate(path: str) -> BaseRecalibratorTables:
    z = np.load(path, allow_pickle=False)
    return BaseRecalibratorTables(
        rg_names=[str(s) for s in z["rg_names"]],
        max_cycle=int(z["max_cycle"]),
        qs_obs=z["qs_obs"], qs_mism=z["qs_mism"],
        cyc_obs=z["cyc_obs"], cyc_mism=z["cyc_mism"],
        ctx_obs=z["ctx_obs"], ctx_mism=z["ctx_mism"],
    )


def load_and_combine_bqsr_tables(dir_or_file: str) -> BaseRecalibratorTables:
    """(reference: print-bqsr.go:309-329)"""
    if os.path.isdir(dir_or_file):
        files = [os.path.join(dir_or_file, f) for f in sorted(os.listdir(dir_or_file))]
    else:
        files = [dir_or_file]
    result = None
    for f in files:
        part = load_intermediate(f)
        result = part if result is None else result.merge(part)
    if result is None:
        raise ValueError(f"no BQSR tables found in {dir_or_file}")
    return result
