"""The ``superpoint_lightglue`` configuration: its entries, its FLOP count
against a hand count of one LightGlue layer and of SuperPoint's VGG, its
five metric readers (None without their record, values on a fabricated
profile and on a traced run's snapshot of the port), and ``correct`` on the
CPU at a small size, which a perturbed output fails."""

import os
import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import helpers
from benchmark.work import superpoint_lightglue as sp_work

CELL = "superpoint_lightglue.seq2048"
CONFIG = os.path.join(harness.BENCH_DIR, "configs",
                      "superpoint_lightglue.json")
PATCH = {"config": {"image_size": [64, 96], "max_num_keypoints": 32},
         "traffic": {"ring": 6, "trace_frames": 2}}
METRICS = ("superpoint_lightglue.mfu", "lightglue.host_ms",
           "superpoint.suppress_us",
           "superpoint_lightglue.host_syncs_per_call",
           "superpoint.keypoints_per_frame")


@pytest.fixture(autouse=True)
def tracing_off():
    from feature_tracker_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def reader(name):
    return harness.Cell(helpers.spec(), CELL).reader(name)


def test_entries_of_the_cell():
    cell = harness.Cell(helpers.spec(), CELL)
    assert cell.chips == 1 and cell.config_entry["reduced"] == []
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms_p95",
                                                    "setup_s"]
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms_p95"
    cfg = cell.config
    assert (cfg["image_size"], cfg["max_num_keypoints"], cfg["nms_radius"],
            cfg["n_layers"], cfg["num_heads"]) == ([768, 1024], 2048, 4, 9,
                                                   4)


def test_flops_against_a_hand_count():
    """One layer at 2048 x 2048, d = 256: per image a self unit of
    qkv (256 -> 768), two 2048x2048x256 attention products, the output
    projection (256 -> 256) and the message MLP (512 -> 512 -> 256); the
    cross unit's qk, v and output projections and MLP on both images and
    two attention products in each direction. SuperPoint's VGG at
    1024x768 convolution by convolution."""
    n, d = 2048, 256
    mac = (n * d * 3 * d + 2 * n * n * d + n * d * d + n * 2 * d * 2 * d
           + n * 2 * d * d) * 2                       # both self units
    mac += 2 * n * (3 * d * d + 2 * d * 2 * d + 2 * d * d)   # cross, sides
    mac += 2 * 2 * n * n * d                          # cross, directions
    assert sp_work.layer_flops(n, n, d) == 2 * mac
    assert sp_work.layer_flops(n, n, d) == 27_380_416_512

    px = 1024 * 768
    convs = [(1, 64, px), (64, 64, px), (64, 64, px // 4), (64, 64, px // 4),
             (64, 128, px // 16), (128, 128, px // 16), (128, 128, px // 64),
             (128, 128, px // 64), (128, 256, px // 64), (128, 256, px // 64)]
    want = sum(2 * 9 * i * o * hw for i, o, hw in convs)
    want += 2 * 256 * (65 + 256) * (px // 64)         # the 1x1 heads
    assert sp_work.superpoint_flops(768, 1024) == want
    cfg = harness.load_json(CONFIG)
    assert 380e9 < sp_work.call_flops(cfg) < 390e9


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_none_without_their_record(name):
    record = types.SimpleNamespace(profile=None, session=None,
                                   latencies=[], tracer=None)
    assert reader(name).read(record) is None


def test_device_readers_on_a_fabricated_profile():
    profile = spans.Profile(
        1.0, 0.5, {"void (anonymous namespace)::detect_suppress_kernel"
                   "<false>(...)": [4, 4 * 2.5e-3], "other": [9, 0.1]},
        {}, 4)
    profile.plain_call_s = 0.05
    session = types.SimpleNamespace(call_flops=lambda: 67e12 * 0.05 * 0.2)
    record = types.SimpleNamespace(profile=profile, session=session,
                                   latencies=[0.05] * 8)
    assert reader("superpoint.suppress_us").read(record) == \
        pytest.approx(2500.0)
    assert reader("superpoint_lightglue.mfu").read(record) == \
        pytest.approx(20.0)
    profile.ops = {"other": [9, 0.1]}
    assert reader("superpoint.suppress_us").read(record) is None


def test_session_on_the_cpu():
    """The cell end to end at a CPU size: ``correct``, the traced run's
    metrics from the port's own spans and counters (no device trace on the
    CPU, so no kernel time)."""
    spec = helpers.spec()
    result, checks = harness.run_cell(spec, CELL, helpers.SEED, 0.5, 0,
                                      "cpu", patch=PATCH)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"frame_ms_p95", "setup_s"}
    traced, _ = harness.run_cell(spec, CELL, helpers.SEED + 1, 3.0, 1, "cpu",
                                 patch=PATCH)
    m = traced["metrics"]
    assert m["superpoint.keypoints_per_frame"]["value"] == 32.0
    assert m["lightglue.host_ms"]["value"] > 0
    # On the CPU the plain suppression reads the device; the card's doesn't.
    assert m["superpoint_lightglue.host_syncs_per_call"]["value"] > 0
    assert 0 < m["superpoint_lightglue.mfu"]["value"] < 100
    assert "superpoint.suppress_us" not in m


def test_correct_fails_on_a_perturbed_output():
    cell = harness.Cell(helpers.spec(), CELL, patch=PATCH)
    session = cell.module.Session(cell.config, cell.traffic, helpers.SEED,
                                  "cpu")
    session.warm_up()
    session.start_window()
    for i in range(3):
        session.keep(i, session.call(i))
    assert all(v <= limit for _, v, limit in session.verify())
    i, (position, before, (uv, desc, mask), matched, status), seen = \
        session.kept.items[1]
    uv = uv.clone()
    uv[0] += 1.0
    scores, logit0, logit1 = seen["lightglue"]
    seen = dict(seen, lightglue=(
        scores + 0.1 * torch.randn(scores.shape), logit0, logit1))
    session.kept.items[1] = (i, (position, before, (uv, desc, mask),
                                 matched, status), seen)
    failed = {name for name, v, limit in session.verify() if v > limit}
    assert {"keypoint_mismatch", "score_gap_mean",
            "score_gap_p99"} <= failed
