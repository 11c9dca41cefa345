"""On the card: one short run of each cell through run.py, correct.

    python -m pytest --noconftest -m cuda gpubench/tests/test_gpubench_card.py

Skips without a CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wgs50x.5step"])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    p = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload", cell,
                        "--seed", "2147483659", "--seconds", "12", "--trace", "0"],
                       cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().split("\n")[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
