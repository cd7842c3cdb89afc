"""The port's utilities: timers, logging, profiling helpers and PNG
rendering, the renderings pixel-equal to the JAX package's."""

import logging
import os

import numpy as np
import pytest
import torch

from feature_tracker_tpu.utils import viz as jviz
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.utils import (
    TickTock,
    report_debug,
    report_error,
    report_info,
    report_warn,
    time_jitted,
)
from feature_tracker_tpu_torch.utils import log, viz
from feature_tracker_tpu_torch.utils.profiling import (
    StageTimer,
    assert_finite,
    trace,
)
from feature_tracker_tpu_torch.utils.viz import (
    COLOR_FAILED,
    COLOR_TRACKED,
    draw_lines,
    draw_points,
    render_dense_flow,
    render_detected_features,
    render_matches,
    render_tracked_features,
    to_rgb,
)


def test_ticktock_measures_time():
    t = TickTock()
    acc = 0
    for i in range(10000):
        acc += i
    ms = t.tock_tick_ms()
    assert ms >= 0.0
    # After tick, the next reading is smaller than a long prior window.
    assert t.tock_ms() <= ms + 1000.0


def test_time_jitted_runs_and_reports():
    out, stats = time_jitted(lambda x: {"y": (x * 2.0,)}, torch.ones(8, 8),
                             iters=3, warmup=2)
    assert stats["mean_ms"] >= 0.0 and stats["compile_ms"] >= 0.0
    np.testing.assert_allclose(out["y"][0].numpy(), 2.0)


def test_draw_points_stamps_color():
    rgb = to_rgb(np.zeros((20, 20), np.float32))
    draw_points(rgb, np.array([[10.0, 5.0]]), COLOR_TRACKED, radius=1)
    assert tuple(rgb[5, 10]) == COLOR_TRACKED
    # Out-of-image points are dropped, not clipped onto the border.
    before = rgb.copy()
    draw_points(rgb, torch.tensor([[100.0, 100.0]]), COLOR_FAILED, radius=1)
    np.testing.assert_array_equal(rgb, before)


def test_draw_lines_connects_endpoints():
    rgb = to_rgb(np.zeros((20, 20), np.float32))
    draw_lines(rgb, np.array([[2.0, 2.0]]), np.array([[15.0, 2.0]]),
               COLOR_TRACKED)
    row = rgb[2, 2:16]
    assert (row == np.array(COLOR_TRACKED)).all(axis=-1).all()


def test_render_tracked_features_status_colors():
    gray = np.zeros((30, 40), np.float32)
    ref = np.array([[5.0, 5.0], [20.0, 10.0]])
    cur = np.array([[8.0, 5.0], [22.0, 10.0]])
    status = np.array([int(TrackStatus.TRACKED),
                       int(TrackStatus.LARGE_RESIDUAL)], np.int8)
    rgb = render_tracked_features(gray, ref, cur, status)
    assert tuple(rgb[5, 8]) == COLOR_TRACKED
    assert tuple(rgb[10, 22]) == COLOR_FAILED


def test_render_matches_side_by_side_shape():
    a = np.zeros((30, 40), np.float32)
    b = np.zeros((20, 50), np.float32)
    canvas = render_matches(a, b, np.array([[5.0, 5.0]]),
                            np.array([[10.0, 5.0]]),
                            np.array([int(TrackStatus.TRACKED)], np.int8))
    assert canvas.shape == (30, 90, 3)
    # Current-image point drawn offset by ref width.
    assert tuple(canvas[5, 40 + 10]) == COLOR_TRACKED


def _scene():
    rng = np.random.default_rng(0)
    gray = rng.uniform(-20, 280, (60, 80)).astype(np.float32)
    ref = rng.uniform(-5, 85, (25, 2)).astype(np.float32)
    cur = ref + rng.normal(0, 4, (25, 2)).astype(np.float32)
    status = rng.integers(0, 5, 25).astype(np.int8)
    flow = rng.normal(0, 3, (2, 60, 80)).astype(np.float32)
    return gray, ref, cur, status, flow


RENDERINGS = {
    "detected": lambda m, g, r, c, s, f: m.render_detected_features(
        g, r, num=20, radius=3),
    "tracked": lambda m, g, r, c, s, f: m.render_tracked_features(
        g, r, c, s),
    "matches": lambda m, g, r, c, s, f: m.render_matches(
        g, g[:50, :70], r, c, s, radius=1),
    "dense": lambda m, g, r, c, s, f: m.render_dense_flow(g, f, step=9),
}


@pytest.mark.parametrize("name", sorted(RENDERINGS))
def test_renderings_pixel_equal_to_jax(name):
    args = _scene()
    want = RENDERINGS[name](jviz, *args)
    got = RENDERINGS[name](viz, *args)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # Tensors in, the same image out.
    targs = [torch.from_numpy(a) for a in args]
    np.testing.assert_array_equal(RENDERINGS[name](viz, *targs), want)


def test_colors_and_png_round_trip(tmp_path):
    for c in ("COLOR_TRACKED", "COLOR_FAILED", "COLOR_REF", "COLOR_LINE",
              "COLOR_DETECT"):
        assert getattr(viz, c) == getattr(jviz, c)
    rgb = render_detected_features(np.zeros((12, 16), np.float32),
                                   np.array([[4.0, 4.0], [-1.0, -1.0]]), 1)
    assert rgb.shape == (12, 16, 3)
    path = os.path.join(tmp_path, "x.png")
    viz.save_png(path, rgb[..., 1].astype(np.float32) * 2.0)
    np.testing.assert_array_equal(
        viz.load_gray_image(path),
        np.clip(rgb[..., 1].astype(np.float32) * 2.0, 0, 255))


def test_report_functions_log_at_their_levels(caplog):
    logger = logging.getLogger("feature_tracker_tpu_torch")
    logger.propagate = True
    try:
        with caplog.at_level(logging.DEBUG, logger=logger.name):
            report_info("hello")
            report_warn("careful")
            report_error("broken")
            report_debug("detail")
    finally:
        logger.propagate = False
    assert [r.levelno for r in caplog.records] == [
        logging.INFO, logging.WARNING, logging.ERROR, logging.DEBUG]
    assert caplog.records[0].getMessage() == \
        f"{log.GREEN}[Info ]{log.RESET} hello"


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a", sync={"x": [torch.ones(3)]}):
        sum(range(1000))
    with t.stage("b"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2
    assert rep["a"]["total_ms"] >= rep["b"]["total_ms"]


def test_assert_finite_names_the_leaf():
    ok = {"x": torch.ones(3), "y": [np.zeros(2), (torch.arange(3),)]}
    assert assert_finite(ok) is ok
    with pytest.raises(FloatingPointError, match=r"state\['y'\]\[1\]\[0\]"):
        assert_finite({"x": torch.ones(3),
                       "y": [np.zeros(2), (torch.tensor([1.0, np.nan]),)]},
                      "state")
    with pytest.raises(FloatingPointError, match=r"value\[0\]"):
        assert_finite([np.array([np.inf])])


def test_trace_writes_a_profile(tmp_path):
    with trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in files)
