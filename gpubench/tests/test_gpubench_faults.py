"""The comparison fails what it must: runs on the CPU at a tiny size,
past the look for a card, with the timed path broken underneath
(faults.py), read ``correct`` false; a sound run reads it true; the
controls fail a number.

The port runs on the CPU here (its native engines and the PairHMM's
plain version): the faults are planted in the code that both devices
share. A one-card cell has no exchange between chips to leave out."""

import pytest

import tiny


# the window of a test run: a job of the 5-step cells takes 1-6 s on a
# loaded CPU here, and a window that ends before the first job does
# judges nothing
WINDOW = 20


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, cell="wgs50x.prep", seed=41, **kw):
    rc, res = tiny.run_cpu(root, cell, seed, **kw)
    assert rc == 0 and res is not None
    return res


def _over(res):
    return sorted(n for n, c in res["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", ["wgs50x.prep", "wgs50x.5step", "capture.5step"])
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell, seconds=WINDOW)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # every exact number at 0 (gvcf_discordant_pct has a limit of its own)
    assert not [n for n, c in res["checks"].items() if c["limit"] == 0 and c["value"] != 0]


@pytest.mark.parametrize("fault,cell,number", [
    ("state_unchanged", "wgs50x.prep", "qual_mismatches"),
    ("half_left_out", "wgs50x.prep", "records_unmatched"),
    ("dup_flipped", "wgs50x.prep", "dup_flag_mismatches"),
    ("gvcf_half", "wgs50x.5step", "gvcf_tiling_errors"),
    ("genotype_flipped", "wgs50x.5step", "gvcf_discordant_pct"),
    ("hets_uncalled", "wgs50x.5step", "gvcf_discordant_pct"),
    ("targets_ignored", "capture.5step", "records_unmatched"),
])
def test_fault_is_not_correct(root, fault, cell, number):
    import contextlib

    import faults

    with contextlib.ExitStack() as stack:
        faults.plant(stack, fault)
        res = _run(root, cell, seconds=WINDOW)
    assert not res["correct"] and number in _over(res), res["checks"]


def test_controls_fail_a_number(root):
    """At a tiny size: BQSR in float32 reads what the reference reads (see
    PERF.md for its readings at the cells' size), and the tables counted
    with the duplicates in them fail both BQSR numbers. The GVCF's control
    is a fault in the program (hets_uncalled, above)."""
    import json
    import os

    import control

    with open(os.path.join(root, "gpubench", "configs", "platinum_wgs50x_2x101.json")) as fh:
        cfg = json.load(fh)
    got = control.run_controls(cfg, 41, os.path.join(root, "control"))
    assert got["dups_in_tables"]["recal_row_mismatches"] > 0
    assert got["dups_in_tables"]["qual_mismatches"] > 0
    assert set(got["float32"]) == {"recal_row_mismatches", "qual_mismatches"}
    assert set(got) == {"float32", "dups_in_tables"}
