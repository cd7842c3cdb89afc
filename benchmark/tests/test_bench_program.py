"""The metrics that read the port's own spans and counters
(``program.py``): a traced run of each configuration on the CPU gives each
a number, and a reader gives None when the port's calls are not the
window's or the port has no tracer."""

import types

import numpy as np
import pytest

from benchmark import harness, program
from benchmark.tests import helpers
from feature_tracker_tpu_torch.pipeline import FrontEndConfig, TrackingFrontEnd
from feature_tracker_tpu_torch.utils import profiling

NEW = {
    "euroc_frontend": ["frontend.host_self_ms", "frontend.upload_ms",
                       "frontend.readback_ms", "pyramid.host_ms",
                       "frontend.host_syncs_per_frame",
                       "detect.suppression_rounds", "klt.launch_host_us",
                       "klt.gn_steps_per_lane"],
    "raft_full_sintel": ["raft.input_ms", "raft.update_host_ms",
                         "raft_lookup.launch_host_us"],
}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def test_every_reader_is_listed_in_its_cells():
    spec = helpers.spec()
    layer = {m["name"]: m for m in spec["per_layer"]}
    for config, names in NEW.items():
        cells = [w["name"] for w in spec["workloads"]
                 if w["config"] == config]
        for name in names:
            assert layer[name]["workloads"] == cells
            assert layer[name]["moves"] == "frame_ms_p95"
            assert layer[name]["source"] in ("program_span",
                                             "program_counter")


@pytest.mark.parametrize("workload,seconds", [("euroc_frontend.churn", 3.0),
                                              ("raft_full_sintel.b1", 8.0)])
def test_traced_run_reads_every_new_metric(workload, seconds):
    """On the CPU the kernel wrappers' spans hold the plain versions, so
    every new metric reads a number. RAFT profiles one call here, so that
    its plain phase fits the window."""
    spec = helpers.spec()
    config = helpers.config_of(spec, workload)
    patch = {k: dict(v) for k, v in helpers.PATCH[config].items()}
    patch["traffic"]["trace_frames"] = min(patch["traffic"]["trace_frames"],
                                           3 if config == "euroc_frontend"
                                           else 1)
    result, _ = harness.run_cell(spec, workload, helpers.SEED, seconds, 1,
                                 "cpu", patch=patch)
    assert result["correct"]
    got = result["metrics"]
    for name in NEW[config]:
        assert name in got and np.isfinite(got[name]["value"]), name
        assert got[name]["value"] >= 0
    if config == "euroc_frontend":
        assert got["frontend.host_syncs_per_frame"]["value"] >= 1
        assert got["klt.gn_steps_per_lane"]["value"] >= 1


class _Session:
    frames_per_call = 1


def _record(calls, profiled):
    return harness.Record(_Session(), [0.001] * calls, 1.0, 1.0,
                          profile=types.SimpleNamespace(calls=profiled))


def _read(name, record):
    cell = harness.Cell(helpers.spec(), "euroc_frontend.churn")
    return cell.reader(name).read(record)


def test_readers_need_the_windows_calls(monkeypatch):
    frames = [np.full((48, 64), 0, np.uint8) for _ in range(6)]
    for k, f in enumerate(frames):
        f[8 + k:24 + k, 10:30] = 200
    profiling.enable()
    fe = TrackingFrontEnd(FrontEndConfig(capacity=16, min_live_tracks=8),
                          device="cpu")
    for f in frames:
        fe.process_frame(f)
    assert _read("frontend.upload_ms", _record(6, 3)) > 0
    assert _read("pyramid.host_ms", _record(6, 3)) > 0
    # One call more or fewer than the window, or no plain phase in full.
    for record in (_record(7, 3), _record(5, 3), _record(6, 4)):
        assert _read("frontend.upload_ms", record) is None
        assert _read("frontend.host_syncs_per_frame", record) is None
    # A port without the tracer.
    monkeypatch.delattr(profiling, "snapshot")
    program._cache.clear()
    assert _read("pyramid.host_ms", _record(6, 3)) is None
