"""Cells are found by name: a new configuration, mix, metric and cell are
new files and entries only. BENCHMARK.json keeps to the contract's form."""

import json
import os
import re
import shutil

import tiny
import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_resolves():
    for w in bench()["workloads"]:
        c = cells.load(tiny.ROOT, w["name"])
        assert c.traffic["command"][0] == "filter"
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_new_files_make_a_new_cell(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(tiny.BENCH, os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    before = {p: open(p, "rb").read() for p in _files(os.path.join(root, "gpubench"))}
    g = os.path.join(root, "gpubench")
    with open(os.path.join(g, "configs", "platinum_wgs50x_2x101.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="hg002_wgs30x_2x150", read_length=150, depth=30)
    with open(os.path.join(g, "configs", "hg002_wgs30x_2x150.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(g, "traffic", "prep.json")) as fh:
        mix = json.load(fh)
    mix.update(name="bam_in", command=[a.replace("{sam}", "{sam}") for a in mix["command"]])
    with open(os.path.join(g, "traffic", "bam_in.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(g, "metrics", "jobs.completed.py"), "w") as fh:
        fh.write("def read(rec):\n    return len([j for j in rec['jobs'] if j['rc'] == 0])\n")
    b = bench()
    b["workloads"].append({"name": "hg002.bam_in", "config": "hg002_wgs30x_2x150",
                           "traffic": "bam_in", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "jobs.completed", "unit": "jobs", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "reads_per_s",
                           "workloads": ["hg002.bam_in"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    c = cells.load(root, "hg002.bam_in", g)
    assert c.config["read_length"] == 150 and c.traffic["name"] == "bam_in"
    assert c.readers["jobs.completed"]({"jobs": [{"rc": 0}, {"rc": 1}]}) == 1
    assert "jobs.completed" not in cells.load(root, "wgs50x.5step", g).readers
    after = {p: open(p, "rb").read() for p in before}
    assert after == before  # no file that was there changed


def _files(top):
    for d, _, names in os.walk(top):
        for n in names:
            yield os.path.join(d, n)


def test_benchmark_json_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["gpubench"]
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"] == "gpubench/configs/%s.json" % c["name"]
        with open(os.path.join(tiny.ROOT, c["file"])) as fh:
            assert sorted(json.load(fh)["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024
