"""``raft.input_h2d_mb`` (``metrics/raft.input_h2d_mb.py``): the port's
``raft.input.h2d_bytes`` per call over the traced run's plain phase, in MB,
and None where the port has no such counter."""

import types

import numpy as np
import pytest

from benchmark import harness, program
from benchmark.tests import helpers
from feature_tracker_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


class _Session:
    frames_per_call = 1


def _record(calls, profiled):
    return harness.Record(_Session(), [0.001] * calls, 1.0, 1.0,
                          profile=types.SimpleNamespace(calls=profiled))


def _read(record):
    cell = harness.Cell(helpers.spec(), "raft_full_sintel.b4")
    return cell.reader("raft.input_h2d_mb").read(record)


def _input_calls(crossed):
    """Four calls as the port records a RAFT call, a ``raft.input`` span
    inside ``raft.forward``; ``crossed(call)``: the bytes it counts, or
    None for a port without the counter."""
    profiling.enable()
    for call in range(4):
        with profiling.span("raft.forward"):
            with profiling.span("raft.input"):
                if crossed(call) is not None:
                    profiling.count("raft.input.h2d_bytes", crossed(call))


def test_input_h2d_mb_is_listed_in_the_raft_cells():
    entry = {m["name"]: m for m in helpers.spec()["per_layer"]}[
        "raft.input_h2d_mb"]
    assert entry == {
        "name": "raft.input_h2d_mb", "unit": "MB", "better": "lower",
        "source": "program_counter", "layer": "RAFT model",
        "moves": "frame_ms_p95",
        "workloads": ["raft_full_sintel.b1", "raft_full_sintel.b4"]}


@pytest.mark.parametrize("crossed,mb", [
    (lambda call: None, None),                  # the parent: no counter
    (lambda call: 10_813_440, 10.81344),        # b4's uint8 frames
    (lambda call: 0, 0.0),                      # frames already on the card
    (lambda call: 1_000_000 * call, 2.5),       # calls 2 and 3 of 4
])
def test_input_h2d_mb_reads_bytes_per_call(crossed, mb):
    _input_calls(crossed)
    program._cache.clear()
    got = _read(_record(4, 2))
    if mb is None:
        assert got is None
    else:
        assert got == pytest.approx(mb)


def test_input_h2d_mb_is_none_without_a_plain_phase():
    _input_calls(lambda call: 1)
    program._cache.clear()
    assert _read(_record(4, 0)) is None
    program._cache.clear()
    assert _read(_record(3, 2)) is None     # calls not the window's


def test_traced_cpu_run_reports_it():
    """On the CPU nothing crosses to a card: the metric reads 0."""
    patch = {k: dict(v) for k, v in helpers.PATCH["raft_full_sintel"].items()}
    patch["traffic"]["trace_frames"] = 1
    result, _ = harness.run_cell(helpers.spec(), "raft_full_sintel.b1",
                                 helpers.SEED, 8.0, 1, "cpu", patch=patch)
    got = result["metrics"]["raft.input_h2d_mb"]
    assert got["unit"] == "MB" and np.isfinite(got["value"])
    assert got["value"] == 0.0
