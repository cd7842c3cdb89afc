"""Each cell, run as the driver runs it (``benchmark/run.py`` in a process
of its own), on the card: exit code 0, a result line that is ``correct``
with every metric the cell names, and the compared numbers as the last
lines of standard error. Skips without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import helpers


def _cells():
    return [w["name"] for w in helpers.spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", _cells())
def test_cell_runs_correct_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", workload, "--seed", str(helpers.SEED + trace),
         # A traced run needs the window the driver gives it, for its
         # profiled, plain and timed calls.
         "--seconds", str(helpers.spec()["run_seconds"]) if trace else "2",
         "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    cell = harness.Cell(helpers.spec(), workload)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(result["metrics"]) == names
    last = proc.stderr.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in last)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
