"""The port's span recorder (elprep_tpu_torch/trace.py) on the CPU: off by
default and empty after a plain run; a ``--timed`` 5-step job (two pool
workers) records every span and counter of the main process, its threads
and the workers, each child inside its parent, on one clock; the outputs
are byte-equal with and without ``--timed``; the phase lines are as
before and the summary lines cannot be taken for phases; the cap drops
and counts."""

import contextlib
import gzip
import io
import os
import random

import pytest
import torch

import samgen
from chip_smoke import realign_soft_clips
from elprep_tpu_torch import cli, trace
from elprep_tpu_torch.hc import parallel

torch.set_num_threads(1)

CONTIGS = [("chr1", 12_000), ("chr2", 8_000)]

# the spans that a pooled --timed 5-step job records (no ``worker.redo``:
# no region of this job reads a non-empty deletions carry, so the pool
# redoes none; tests/test_torch_hc_pool.py records one)
NAMES = ["job", "phase.read", "phase.bqsr.tables", "phase.bqsr.apply", "phase.write",
         "phase.hc", "read.parse", "read.dedup", "read.sort", "write.bam", "hc.wait",
         "hc.recv", "hc.combine", "pairhmm.batch", "pairhmm.pack", "pairhmm.device",
         "pairhmm.rescue", "pairhmm.send", "worker.task", "worker.geno", "worker.act"]

PHASES = ["Reading SAM into memory and applying filters.", "Base recalibration.",
          "Apply BQSR.", "Write to file.", "Calling variants."]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 5-step command on two pool workers, on the CPU, once without
    and once with --timed: each run's output directory, standard error
    and the recorder's snapshot after it."""
    wd = tmp_path_factory.mktemp("torch_trace")
    genome = samgen.make_genome(CONTIGS, seed=41)
    rng = random.Random(43)
    alt, snps = {}, []
    for name, ln in CONTIGS:
        seq = bytearray(genome[name])
        for p in range(300, ln - 300, 400):
            p += rng.randrange(-100, 100)
            seq[p] = ord(rng.choice([b for b in "ACGT" if ord(b) != seq[p]]))
            snps.append((name, p))
        alt[name] = bytes(seq)
    header = samgen.make_header_lines(
        CONTIGS, rgs=[{"ID": "rg1", "LB": "lib1", "SM": "s1", "PU": "u1"}])
    lines = realign_soft_clips(samgen.reads_from_genome(2400, CONTIGS, alt, seed=47,
                                                        rg_ids=["rg1"]))
    dups = []
    for k in range(80):
        f, m = lines[4 * k].split("\t"), lines[4 * k + 1].split("\t")
        for c in range(2):
            q = "M01:1:FC:1:2208:%d:%d" % (1000 + 37 * k + c, 2000 + 41 * k + c)
            dups += ["\t".join([q] + f[1:]), "\t".join([q] + m[1:])]
    (wd / "in.sam").write_text("\n".join(header + lines + dups) + "\n")
    with open(wd / "ref.fasta", "w") as fh:
        for name, _ in CONTIGS:
            fh.write(">%s\n%s\n" % (name, genome[name].decode()))
    (wd / "sites.bed").write_text("".join("%s\t%d\t%d\n" % (n, p, p + 1) for n, p in snps))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELPREP_TPU_TORCH_DEVICE", "cpu")
        assert cli.main(["fasta-to-elfasta", str(wd / "ref.fasta"), str(wd / "ref.elfasta")]) == 0
        assert cli.main(["bed-to-elsites", str(wd / "sites.bed"), str(wd / "sites.elsites")]) == 0
        out = {}
        trace.clear()
        for tag in ("plain", "timed"):
            od = wd / tag
            od.mkdir()
            argv = ["filter", str(wd / "in.sam"), str(od / "out.bam"),
                    "--mark-duplicates", "--mark-optical-duplicates", str(od / "metrics.txt"),
                    "--sorting-order", "coordinate", "--bqsr", str(od / "out.recal"),
                    "--known-sites", str(wd / "sites.elsites"), "--reference",
                    str(wd / "ref.elfasta"), "--haplotypecaller", str(od / "out.vcf.gz"),
                    "--reference-confidence", "GVCF", "--nr-of-threads", "2",
                    "--pg-cmd-line", "elprep filter in.sam out.bam"]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                assert cli.main(argv + (["--timed"] if tag == "timed" else [])) == 0
            out[tag] = {"dir": od, "stderr": err.getvalue(), "snap": trace.snapshot()}
        out["worker_pids"] = {w["pid"] for w in parallel.get_pool(2).probe_workers()}
        trace.clear()
    return out


def _body(path):
    data = open(path, "rb").read()
    if path.endswith(".gz"):
        data = gzip.decompress(data)
    if path.endswith("metrics.txt"):
        return data[data.index(b"## METRICS CLASS"):]
    return b"\n".join(ln for ln in data.split(b"\n") if not ln.startswith(b"##elPrepCommandLine"))


def test_off_records_nothing(runs):
    assert not trace.enabled()
    snap = runs["plain"]["snap"]
    assert snap["spans"] == [] and snap["counters"] == [] and snap["dropped"] == 0
    assert trace.span("x") is trace.NOOP and trace.counting("x") is trace.NOOP
    trace.count("x")
    assert trace.snapshot()["counters"] == []
    assert "trace:" not in runs["plain"]["stderr"]


@pytest.mark.parametrize("name", ["out.bam", "metrics.txt", "out.recal", "out.vcf.gz"])
def test_outputs_equal_with_and_without_timed(runs, name):
    plain, timed = (str(runs[t]["dir"] / name) for t in ("plain", "timed"))
    if name in ("out.bam", "out.recal"):
        assert open(plain, "rb").read() == open(timed, "rb").read()
    else:
        assert _body(plain) == _body(timed)


def test_timed_records_every_name(runs):
    snap = runs["timed"]["snap"]
    spans = snap["spans"]
    got = {s["name"] for s in spans}
    assert set(NAMES) <= got, sorted(set(NAMES) - got)
    sw = [c for c in snap["counters"] if c["name"] == "hc.sw"]
    assert sw and all(c["count"] > 0 and c["ns"] > 0 for c in sw)
    # GVCF: the carry is non-empty after the first called site, and the
    # speculative genotypes that never read it are kept
    kept = [c for c in snap["counters"] if c["name"] == "hc.carry_kept"]
    assert kept and all(c["count"] > 0 and c["proc"] == "main" for c in kept)
    # the workers' records came back from the workers, under their pids
    me = os.getpid()
    workers = {s["pid"] for s in spans if s["proc"] == "worker"}
    assert workers and me not in workers and workers <= runs["worker_pids"]
    assert {s["pid"] for s in spans if s["name"].startswith("worker.")} == workers
    assert {c["pid"] for c in sw} <= workers
    assert all(s["pid"] == me for s in spans if s["proc"] == "main")
    # one job, and the threads named
    assert len({s["job"] for s in spans}) == 1 and snap["dropped"] == 0
    threads = {s["name"]: s["thread"] for s in spans}
    assert threads["hc.combine"] == "hc-combiner"
    assert threads["pairhmm.batch"].startswith("pairhmm-dispatch")
    assert threads["write.bam"] == "output-writer"
    assert threads["hc.wait"] == threads["phase.hc"] == threads["job"]
    batch = [s for s in spans if s["name"] == "pairhmm.batch"]
    assert all(s["attrs"]["regions"] > 0 and s["attrs"]["pairs"] > 0
               and s["attrs"]["wait_max_ns"] >= 0
               and s["attrs"]["wait_sum_ns"] >= s["attrs"]["wait_max_ns"] for s in batch)
    tasks = [s for s in spans if s["name"] == "worker.task"]
    assert all(s["attrs"]["regions"] > 0 and s["attrs"]["sent"] <= s["start"] for s in tasks)


def test_children_inside_parents(runs):
    spans = runs["timed"]["snap"]["spans"]
    by_id = {(s["pid"], s["id"]): s for s in spans}
    kids = [s for s in spans if s["parent"] is not None]
    assert len(kids) > 20
    for s in kids:
        p = by_id[(s["pid"], s["parent"])]
        assert p["job"] == s["job"] and p["thread"] == s["thread"]
        assert p["start"] <= s["start"] <= s["end"] <= p["end"], (p["name"], s["name"])
    parents = {(s["name"], by_id[(s["pid"], s["parent"])]["name"]) for s in kids}
    assert {("phase.hc", "job"), ("read.parse", "phase.read"), ("hc.wait", "phase.hc"),
            ("pairhmm.device", "pairhmm.batch"), ("pairhmm.pack", "pairhmm.batch")} <= parents


def test_worker_tasks_inside_the_hc_phase(runs):
    """One clock in every process: each worker's task lies inside the main
    process's phase.hc span of its job."""
    spans = runs["timed"]["snap"]["spans"]
    hc = {s["job"]: s for s in spans if s["name"] == "phase.hc"}
    tasks = [s for s in spans if s["proc"] == "worker"]
    assert tasks
    for s in tasks:
        assert hc[s["job"]]["start"] <= s["start"] <= s["end"] <= hc[s["job"]]["end"]


def test_phase_lines_as_before_and_summary_lines_not_phases(runs):
    err = runs["timed"]["stderr"].splitlines()
    phase = [ln for ln in err if ln.endswith(".") or ln.startswith("  done in ")]
    assert phase[0::2] == PHASES
    assert all(ln.startswith("  done in ") and ln.endswith("s") for ln in phase[1::2])
    summary = [ln for ln in err if ln.startswith("trace: ")]
    assert len(summary) >= len(NAMES)
    for ln in summary:
        s = ln.strip()
        assert not s.endswith(".") and not s.startswith("done in"), ln
    assert any(" worker MainThread hc.sw calls=" in ln for ln in summary)
    assert any(ln.startswith("trace: main MainThread phase.hc n=1 ") for ln in summary)
    # and the plain run prints the same lines but for the phase lines
    assert [ln for ln in runs["plain"]["stderr"].splitlines() if ln.endswith(".")] == []


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    trace.clear()
    trace.enable("capped")
    try:
        for _ in range(8):
            with trace.span("s"):
                trace.count("c", 2, 10)
    finally:
        trace.disable()
    snap = trace.snapshot()
    assert len(snap["spans"]) == 5 and snap["dropped"] == 3
    assert [(c["count"], c["ns"]) for c in snap["counters"]] == [(16, 80)]
    # a drained process's records merge up to the cap, the rest counted
    other = trace.drain()
    trace.merge({"spans": other["spans"][:3], "counters": other["counters"], "dropped": 1})
    trace.merge({"spans": other["spans"], "counters": [], "dropped": 0})
    snap = trace.snapshot()
    assert len(snap["spans"]) == 5 and snap["dropped"] == 1 + 3
    assert any("dropped beyond the cap of 5" in ln for ln in trace.summary("capped"))
    trace.clear()
