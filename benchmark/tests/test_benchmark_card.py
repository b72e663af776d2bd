"""On the card: each cell's lower-precision control, and a training
cell's half-batch fault, come out not correct at the cell's own size, and
a sound run comes out correct; one traced run of the command ends with a
well-formed line. Skips where there is no CUDA card.

    python3 -m pytest benchmark/tests/test_benchmark_card.py -m gpu -q
"""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, compare, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 977


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def _limits(cell):
    return cell.workload["limits"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cls-train-b512", "gen-train-b512",
                                  "cls-infer-b512"])
def test_control_and_faults_are_not_correct(card, name):
    cell = harness.load_cell(name)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.workload['driver']}")
    out = driver.run(cell, SEED, 0.05, False, card, time.perf_counter())
    assert out["correct"] is True, out["check"]
    readings = calibrate.control_readings(cell, driver, SEED, out, card)
    for kind, numbers in readings.items():
        ok, check = compare.judge(numbers, _limits(cell))
        assert not ok, (kind, check)


@pytest.mark.gpu
def test_traced_run_of_the_command(card):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cls-infer-b512",
         "--seed", str(SEED + 1), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, m in line["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] < 100, (name, m)
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
