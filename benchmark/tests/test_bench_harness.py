"""The harness on the CPU: cells, traffic and metrics found by name, a new
cell added as data alone, the result line's keys, the end-to-end
arithmetic over every frame of a window, the traced run's two phases, the
traffic's closed loop, and ``BENCHMARK.json``'s shape."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import frames, harness, spans
from benchmark.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_name_resolves_to_its_files():
    spec = helpers.spec()
    bench = harness.BENCH_DIR
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert os.path.exists(os.path.join(bench, "configs",
                                           c["name"] + ".py"))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(bench, "traffic",
                                           w["traffic"] + ".json"))
        cell = harness.Cell(spec, w["name"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)


def test_benchmark_json_keeps_the_contract_shape():
    spec = helpers.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    checks = 2 + 14 * 24
    assert checks * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(spec)) <= 64 * 1024


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    # A traced run needs room for the profiled, the plain and timed calls.
    result, checks = helpers.run("euroc_frontend.steady",
                                 seconds=1.5 if trace else 0.5, trace=trace)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) == set(RESULT_KEYS + ["checks"]
                            + (["breakdown"] if trace else []))
    assert result["correct"] is True and result["attempted"] > 0
    assert len(checks) == len(result["checks"]) > 0
    cell = harness.Cell(helpers.spec(), "euroc_frontend.steady")
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    # On the CPU no device metric has anything to read.
    assert {n for n in names if "roofline" not in n
            and n != "device.idle_share"} <= set(result["metrics"]) <= names
    assert ("frame_ms_p95" in result["metrics"]) == (not trace)
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    json.dumps(result)


def test_a_cell_added_as_data_alone(tmp_path):
    """A new traffic file and a new workload entry, and no code, give a
    cell that runs."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(bench / "traffic" / "drift.json", "w") as fh:
        json.dump({"ring": 6, "speed_px": [3.0, 6.0], "direction": None,
                   "turn_rad": [-0.01, 0.01], "zoom": [1.0, 1.0],
                   "batch": 1, "trace_frames": 4, "warm_frames": 2}, fh)
    spec = helpers.spec()
    spec["workloads"].append({"name": "euroc_frontend.drift",
                              "config": "euroc_frontend",
                              "traffic": "drift", "chips": 1,
                              "why": "a test's cell"})
    result, _ = harness.run_cell(
        spec, "euroc_frontend.drift", helpers.SEED, 0.3, 0, "cpu",
        bench_dir=str(bench), patch={"config": {"height": 96, "width": 128}})
    assert result["correct"] and result["attempted"] > 0
    # Metrics without a ``workloads`` list report in the new cell too; those
    # with one, only in the cells it names.
    assert set(result["metrics"]) == {"frame_ms_p95", "setup_s"}


class _Session:
    def __init__(self, frames_per_call):
        self.frames_per_call = frames_per_call


def _read(name, latencies, window_s, frames_per_call=1):
    cell = harness.Cell(helpers.spec(), "euroc_frontend.steady")
    record = harness.Record(_Session(frames_per_call), latencies, window_s,
                            1.0)
    return cell.reader(name).read(record)


def test_rate_and_tail_over_every_frame_with_a_planted_stall():
    lat = [0.002] * 190 + [0.050] * 10          # ten stalls in 200 frames
    window = sum(lat)
    assert _read("frames_per_s", lat, window) == pytest.approx(200 / window)
    # The tail of all frames: 5 % of 200 is 10 frames, the stalls.
    assert _read("frame_ms_p95", lat, window) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert _read("frame_ms_p95", lat, window) > 2.0
    # A batch of 4 pairs a call: 4 frames a call, sharing its latency.
    assert _read("frames_per_s", lat, window, 4) == pytest.approx(
        800 / window)
    assert _read("frame_ms_p95", [0.01] * 19 + [0.5], 0.69, 4) == \
        pytest.approx(np.percentile([0.01] * 76 + [0.5] * 4, 95) * 1e3)
    # A single stall in a hundred frames stays out of the 95th percentile.
    assert _read("frame_ms_p95", [0.002] * 99 + [1.0], 1.198) == \
        pytest.approx(2.0)


def test_spans_time_only_after_the_profiled_calls():
    """The profiled calls carry bare ranges (no synchronise, no duration);
    every call is counted, and the later ones are timed."""
    tracer = spans.Tracer("cpu")
    step = tracer.wrap("step", lambda x: x + 1, sync=True)
    for call in range(3):
        tracer.call = call
        tracer.timing = call >= 2
        assert step(call) == call + 1
    assert tracer.count("step") == 3
    assert tracer.count("step", below=2) == 2
    assert len(tracer.seconds("step")) == 1


def test_a_loop_closes_its_path_and_replays_forward():
    traffic = {"ring": 64, "replay": "loop", "speed_px": [3.0, 7.0],
               "direction": "circle", "turn_rad": [-0.004, 0.004]}
    tx, ty, angle, scale = frames.camera_path(traffic, helpers.SEED)
    pos = np.stack([tx, ty], -1)
    steps = np.diff(np.concatenate([pos, pos[:1]]), axis=0)
    # The step from the last frame back to the first is one of the path's.
    lengths = np.linalg.norm(steps, axis=-1)
    assert 2.5 < lengths.min() and lengths.max() < 7.5
    assert abs(angle[-1]) < 0.004 + 1e-9 and np.all(scale == 1.0)
    assert [frames.frame_index(traffic, 64, k) for k in (0, 63, 64, 65)] \
        == [0, 63, 0, 1]
    assert frames.sequence_period(traffic, 64) == 64
    pong = {"ring": 4}
    assert [frames.frame_index(pong, 4, k) for k in range(8)] == \
        [0, 1, 2, 3, 2, 1, 0, 1]
    assert frames.sequence_period(pong, 4) == 6


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "euroc_frontend.steady", "--seed", str(helpers.SEED), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run_py(harness.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_no_result_without_the_port(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files
    gives no result."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(helpers.SPEC_PATH, tmp_path / "BENCHMARK.json")
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
