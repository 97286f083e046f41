"""On the card only (marker ``cuda``; run with ``python -m pytest -m cuda
benchmark/tests``): one short run of each cell through the command the
driver uses, whose last line must be a correct result on the card."""

import json
import subprocess
import sys

import pytest
import torch

from _paths import BENCH, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "2400000001", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
