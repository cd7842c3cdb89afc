"""``detect.kernel_share`` (``metrics/detect.kernel_share.py``): the port's
``detect.suppression_kernel`` over the ``detect.features`` calls of the
traced run's plain phase, in %, and None where the port has no such
counter or the phase has no detection."""

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
    cell = harness.Cell(helpers.spec(), "euroc_frontend.churn")
    return cell.reader("detect.kernel_share").read(record)


def _frames(launched):
    """Six frames as the port records them, a ``detect.features`` span
    inside ``frontend.frame`` on the frames ``launched(frame)`` does not
    call None, counting what it returns (1: the kernel, 0: the plain
    version; ``"absent"``: a port without the counter)."""
    profiling.enable()
    for frame in range(6):
        with profiling.span("frontend.frame"):
            counted = launched(frame)
            if counted is None:
                continue
            with profiling.span("detect.features"):
                if counted != "absent":
                    profiling.count("detect.suppression_kernel", counted)


def test_kernel_share_is_listed_in_the_front_end_cells():
    entry = {m["name"]: m for m in helpers.spec()["per_layer"]}[
        "detect.kernel_share"]
    assert entry == {
        "name": "detect.kernel_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "detection",
        "moves": "frame_ms_p95",
        "workloads": ["euroc_frontend.steady", "euroc_frontend.churn"]}


@pytest.mark.parametrize("launched,share", [
    (lambda frame: "absent", None),             # the parent: no counter
    (lambda frame: None, None),                 # no detection at all
    (lambda frame: 1, 100.0),                   # every call launched
    (lambda frame: 1 if frame % 2 else None, 100.0),
    (lambda frame: 0, 0.0),                     # the plain version (CPU)
    # Frames 3-5 are the window.
    (lambda frame: {0: 1, 3: 1, 4: 0}.get(frame), 50.0),
    # A detection in the window, the counter only before it.
    (lambda frame: {0: 1, 3: "absent"}.get(frame), 0.0),
])
def test_kernel_share_reads_launches_per_detection(launched, share):
    _frames(launched)
    program._cache.clear()
    got = _read(_record(6, 3))
    if share is None:
        assert got is None
    else:
        assert got == pytest.approx(share)


def test_kernel_share_is_none_without_a_plain_phase():
    _frames(lambda frame: 1)
    program._cache.clear()
    assert _read(_record(6, 0)) is None
    program._cache.clear()
    assert _read(_record(5, 2)) is None     # calls not the window's


def test_traced_cpu_run_reports_it():
    """On the CPU every detection runs the plain version: the metric
    reads 0."""
    patch = {k: dict(v) for k, v in helpers.PATCH["euroc_frontend"].items()}
    patch["traffic"]["trace_frames"] = 3
    result, _ = harness.run_cell(helpers.spec(), "euroc_frontend.churn",
                                 helpers.SEED, 3.0, 1, "cpu", patch=patch)
    got = result["metrics"]["detect.kernel_share"]
    assert got["unit"] == "%" and np.isfinite(got["value"])
    assert got["value"] == 0.0
