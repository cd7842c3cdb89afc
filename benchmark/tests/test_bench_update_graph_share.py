"""``raft.update_graph_share`` (``metrics/raft.update_graph_share.py``):
the port's graph replays over its ``raft.update`` spans in the traced run's
plain phase, and None where the port counts no replays."""

import types

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
    cell = harness.Cell(helpers.spec(), "raft_full_sintel.b1")
    return cell.reader("raft.update_graph_share").read(record)


def _update_calls(replays):
    """Four calls as the port records a RAFT call, each a ``raft.forward``
    span around three ``raft.update`` spans; ``replays(call, k)``: whether
    update ``k`` of ``call`` counts a replay of its graph."""
    profiling.enable()
    for call in range(4):
        with profiling.span("raft.forward"):
            for k in range(3):
                with profiling.span("raft.update"):
                    if replays(call, k):
                        profiling.count("raft.update_graph.replays")


def test_update_graph_share_is_listed_in_the_raft_cells():
    spec = helpers.spec()
    entry = {m["name"]: m for m in spec["per_layer"]}[
        "raft.update_graph_share"]
    assert entry["workloads"] == ["raft_full_sintel.b1", "raft_full_sintel.b4"]
    assert (entry["layer"], entry["moves"], entry["source"]) == (
        "RAFT model", "frame_ms_p95", "program_counter")


@pytest.mark.parametrize("replays,share", [
    (lambda call, k: False, None),          # no graph path: no counter
    (lambda call, k: True, 100.0),
    (lambda call, k: k == 0, 100.0 / 3),
    (lambda call, k: call < 2, 0.0),        # replays outside the window
])
def test_update_graph_share_reads_replays_over_updates(replays, share):
    _update_calls(replays)
    program._cache.clear()
    got = _read(_record(4, 2))
    if share is None:
        assert got is None
    else:
        assert got == pytest.approx(share)
