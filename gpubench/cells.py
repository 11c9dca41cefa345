"""A cell of BENCHMARK.json and the files that make it, found by name:

    configs/<config>.json     the deployment (sizes, shares, limits)
    traffic/<traffic>.json    the job's command line and pool size
    metrics/<metric>.py       one reader per per-layer metric

A new configuration, mix, metric or cell is new files and entries; no
file here needs an edit for it."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class CellError(ValueError):
    """BENCHMARK.json does not name the cell, or a file of it is missing."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _json(path: str) -> dict:
    if not os.path.exists(path):
        raise CellError("missing %s" % path)
    with open(path) as fh:
        return json.load(fh)


def load_reader(path: str) -> Callable:
    """The ``read(rec)`` function of a metric's file."""
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str, bench_dir: Optional[str] = None) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json, with its
    configuration, traffic and the readers of its per-layer metrics."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    here = bench_dir or HERE
    for w in bench["workloads"]:
        if w["name"] != workload:
            continue
        cfg = _json(os.path.join(here, "configs", w["config"] + ".json"))
        traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
        e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
        layers = [m for m in bench["per_layer"] if _applies(m, workload)]
        readers = {}
        for m in layers:
            path = os.path.join(here, "metrics", m["name"] + ".py")
            if not os.path.exists(path):
                raise CellError("missing %s" % path)
            readers[m["name"]] = load_reader(path)
        return Cell(workload, int(w["chips"]), cfg, traffic, e2e, layers, readers)
    raise CellError("BENCHMARK.json names no workload %r" % workload)
