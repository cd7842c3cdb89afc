"""The ``cotracker2_online`` configuration: its four metric readers (None
without their record, values on a fabricated one), its work arithmetic
against a direct count at a small shape, and its session end to end at a
size the CPU holds (``Cell(..., patch=...)``)."""

import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark import harness, spans, work
from benchmark.tests import helpers
from benchmark.work import cotracker2 as cot_work

CELL = "cotracker2_online.grid50"
CONFIG = os.path.join(harness.BENCH_DIR, "configs", "cotracker2_online.json")
PATCH = {"config": {"model_resolution": [64, 64], "hidden_size": 32,
                    "num_heads": 2, "time_depth": 2, "space_depth": 2,
                    "num_virtual_tracks": 8},
         "traffic": {"ring": 12, "clip_frames": 12, "grid_size": 4,
                     "trace_frames": 2}}
METRICS = ("cotracker2.mfu", "cotracker2.lookup_roofline",
           "cotracker2.former_host_ms", "cotracker2.frames_encoded_per_call")


def reader(name):
    spec = helpers.spec()
    return harness.Cell(spec, CELL).reader(name)


def test_entries_of_the_cell():
    spec = helpers.spec()
    cell = harness.Cell(spec, CELL)
    assert cell.chips == 1 and cell.config_entry["reduced"] == []
    names = [m["name"] for m in cell.per_layer]
    assert names == list(METRICS)
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms_p95",
                                                    "setup_s"]
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms_p95"


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_none_without_their_record(name):
    record = types.SimpleNamespace(profile=None, session=None,
                                   latencies=[], tracer=None)
    assert reader(name).read(record) is None


class _Session:
    def __init__(self, w):
        self.w = w

    def traced_work(self, calls):
        return self.w

    def calls_flops(self, calls, first, last):
        return self.w["window_call_flops"] * (last - first)


def test_mfu_and_roofline_on_a_fabricated_record():
    profile = spans.Profile(1.0, 0.5, {"raft_lookup_kernel<8, 4, true>":
                                       [10, 10 * 0.2e-3]}, {}, 4)
    profile.plain_call_s = 0.02
    w = {"lookup_bytes": 3.35e6, "lookup_flops": 0.0,
         "window_call_flops": 989e12 * 0.02 * 0.25}
    record = types.SimpleNamespace(profile=profile, session=_Session(w),
                                   latencies=[0.02] * 8)
    assert reader("cotracker2.mfu").read(record) == pytest.approx(25.0)
    # 3.35 MB at 3.35 TB/s: 1 us of a 200 us launch.
    assert reader("cotracker2.lookup_roofline").read(record) == \
        pytest.approx(0.5)


def test_program_readers_on_a_fabricated_record(monkeypatch):
    from feature_tracker_tpu_torch.utils import profiling

    snap = types.SimpleNamespace(
        names=["cotracker2.former", "cotracker2.window",
               "cotracker2.frames_encoded"], calls=4)
    name = np.array([0, 1, 0, 1, 0, 0])
    call = np.array([2, 2, 3, 3, 1, 0])
    dur = np.array([2e6, 9e6, 4e6, 9e6, 1e6, 1e6])

    def select(n, window):
        m = name == snap.names.index(n)
        return m & (call >= window[0]) & (call < window[1])

    snap.select, snap.call, snap.duration_ns = select, call, dur
    snap.counter = lambda n, window: 16 if n == snap.names[2] else 0
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    profile = spans.Profile(1.0, 0.5, {}, {}, 2)
    record = types.SimpleNamespace(profile=profile, latencies=[0.0] * 4)
    assert reader("cotracker2.former_host_ms").read(record) == \
        pytest.approx(3.0)
    assert reader("cotracker2.frames_encoded_per_call").read(record) == \
        pytest.approx(8.0)
    snap.names = snap.names[:2]
    assert reader("cotracker2.frames_encoded_per_call").read(record) is None


def test_work_against_a_direct_count():
    """The former's FLOPs against the products counted one by one at a
    small shape, and the border-mode lookup's dots against a loop over
    grid pixels."""
    cfg = dict(harness.load_json(CONFIG),
               hidden_size=16, num_virtual_tracks=3, time_depth=2,
               space_depth=2, input_dim=10, latent_dim=6, window_len=2,
               mlp_ratio=2.0)
    n, s, d, v, f = 5, 2, 16, 3, 32

    def lin(tokens, i, o):
        return 2 * tokens * i * o

    def block(tokens_q, tokens_kv, ln, self_attn):
        q = lin(tokens_q, d, d) + lin(tokens_q, d, d)           # q, out
        kv = lin(tokens_kv, d, 2 * d)
        att = 2 * 2 * tokens_q * (tokens_kv if not self_attn else ln) * d
        return q + kv + att + lin(tokens_q, d, f) + lin(tokens_q, f, d)

    want = lin(n * s, 10, d) + lin(n * s, d, 8)
    want += 2 * block((n + v) * s, (n + v) * s, s, True)
    for _ in range(2):
        want += s * (block(v, n, 0, False) + block(v, v, v, True)
                     + block(n, v, 0, False))
    assert cot_work.former_flops(cfg, n) == want

    rng = np.random.default_rng(0)
    locs = torch.from_numpy(rng.uniform(-30, 60, (2, 3, 4, 2)).astype(
        np.float32))
    locs[0, 0, 0] = float("nan")
    pyr = [(2, 20, 24, 8), (2, 10, 12, 8)]
    r = 2
    nbytes, flops = cot_work.lookup_work_border((2, 3, 4, 8), pyr, locs, r)
    dots = 0
    for loc in locs.reshape(-1, 2).tolist():
        if not all(math.isfinite(c) for c in loc):
            continue
        for lvl, (_, h, w, _) in enumerate(pyr):
            cx = min(max(loc[0] / 2 ** lvl, -r), w - 1 + r)
            cy = min(max(loc[1] / 2 ** lvl, -r), h - 1 + r)
            x0, y0 = math.floor(cx) - r, math.floor(cy) - r
            dots += sum(0 <= x0 + i < w and 0 <= y0 + j < h
                        for i in range(2 * r + 2) for j in range(2 * r + 2))
    out_n = 24 * 2 * 25
    assert flops == 24 * 8 + dots * 2 * 8 + out_n * 7
    assert nbytes == 4 * (24 * 8 + 2 * 20 * 24 * 8 + 2 * 10 * 12 * 8
                          + locs.numel() + out_n)
    zeros_bytes, _ = work.lookup_work((2, 3, 4, 8), pyr, locs, r)
    assert zeros_bytes == nbytes


def test_border_work_is_chip_smokes():
    """``lookup_work_border`` gives what ``chip_smoke.py``'s
    ``lookup_work`` gives in border mode, on grid, off-map, runaway and NaN
    locations."""
    smoke = harness.load_module(os.path.join(harness.ROOT, "chip_smoke.py"),
                                "chip_smoke_for_bench_cotracker2")
    rng = np.random.default_rng(1)
    f0 = torch.empty((2, 6, 8, 16))
    pyr = [torch.empty((2, 24 >> lvl, 32 >> lvl, 16)) for lvl in range(4)]
    locs = torch.from_numpy(rng.uniform(-40, 70, (2, 6, 8, 2)).astype(
        np.float32))
    locs[0, 0, :4, 0] = torch.tensor([float("nan"), float("inf"), 1e9,
                                      -1e9])
    want = smoke.lookup_work(f0, pyr, locs, 3, "border")
    assert cot_work.lookup_work_border(
        tuple(f0.shape), [tuple(p.shape) for p in pyr], locs, 3) == want
    assert want != smoke.lookup_work(f0, pyr, locs, 3)


def test_encoder_flops_count_each_convolution():
    cfg = harness.load_json(CONFIG)
    # 7x7 stem at 192x256, 3x3 convolutions of the four stages, the 1x1
    # projections, the 416 -> 256 and 256 -> 128 heads, one frame.
    convs = [(49, 3, 64, 192 * 256)]
    convs += [(9, 64, 64, 192 * 256)] * 4
    for c_in, c, hw in ((64, 96, 96 * 128), (96, 128, 48 * 64),
                        (128, 128, 24 * 32)):
        convs += [(1, c_in, c, hw), (9, c_in, c, hw)] + [(9, c, c, hw)] * 3
    convs += [(9, 416, 256, 96 * 128), (1, 256, 128, 96 * 128)]
    want = sum(2 * k * i * o * hw for k, i, o, hw in convs)
    assert cot_work.encoder_flops(cfg, 1) == want


def test_session_on_the_cpu():
    """The cell's session end to end at a CPU size: the result line, the
    traced metrics and the comparison with the reference."""
    spec = helpers.spec()
    result, checks = harness.run_cell(spec, CELL, helpers.SEED, 0.5, 0,
                                      "cpu", patch=PATCH)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert [c[0] for c in checks] == ["track_gap_px", "track_p99_gap_px",
                                      "vis_logit_gap"]
    assert result["attempted"] % 4 == 0
    traced, _ = harness.run_cell(spec, CELL, helpers.SEED + 1, 4.0, 1,
                                 "cpu", patch=PATCH)
    m = traced["metrics"]
    assert m["cotracker2.frames_encoded_per_call"]["value"] == 8.0
    assert m["cotracker2.former_host_ms"]["value"] > 0
    assert 0 < m["cotracker2.mfu"]["value"] < 100
    assert "cotracker2.lookup_roofline" not in m      # no device trace
