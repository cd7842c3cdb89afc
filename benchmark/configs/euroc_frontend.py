"""Session of the ``euroc_frontend`` configuration: the port's persistent KLT
front end, ``TrackingFrontEnd.process_frame``, one host ``uint8`` frame a
call, held to ``reference/frontend.py``.

What is compared (once the window has closed): the frames of a sample drawn
from the seed while the window runs (the window's first frame, ``SAMPLE``
more and up to ``REPLENISHED`` of the frames on which the port replenished,
each a reservoir sample over the window), each worked out by the reference
from the raw frames. The first frame starts from
nothing; every other sampled frame starts from the port's own state after
the frame before it (the reference cannot follow ten thousand frames in
less time than the window: a status flipped by rounding would part the two
for good). Numbers compared, over the sample:

- ``uv_off_share``: of the lanes tracked on both sides (detections
  included), the share whose |x| or |y| differs by more than
  ``UV_TOLERANCE_PX``;
- ``status_mismatch``: lanes whose status differs, as a share of all lanes;
- ``id_mismatch``: lanes whose track id differs, as a share of all lanes.

The limits come from readings of the port over a dozen seeds (lower) and of
the control, the reference in bfloat16 in the port's place (upper); see
``PERF.md``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import frames, work
from benchmark.harness import Reservoir
from benchmark.reference import frontend as ref

SAMPLE = 24
REPLENISHED = 4
WORK_SAMPLE = 16          # traced frames whose Gauss-Newton steps are counted
# The port's largest gap over a dozen seeds was 1.8e-4 px (PERF.md); a lane
# whose Gauss-Newton loop stops one step earlier on one side (its squared
# step on the two sides of the convergence threshold) moves by a step.
UV_TOLERANCE_PX = 0.01
LIMITS = {"uv_off_share": 1e-3, "status_mismatch": 3e-3, "id_mismatch": 3e-2}


def port_config(cfg):
    from feature_tracker_tpu_torch.core.config import (HarrisOptions,
                                                       KltMethod, KltOptions)
    from feature_tracker_tpu_torch.pipeline import FrontEndConfig

    klt = dict(cfg["klt"])
    klt["method"] = KltMethod(klt["method"])
    return FrontEndConfig(
        capacity=cfg["capacity"], pyramid_levels=cfg["pyramid_levels"],
        min_live_tracks=cfg["min_live_tracks"],
        replenish_suppression=cfg["replenish_suppression"],
        klt=KltOptions(**klt), harris=HarrisOptions(**cfg["harris"]))


class Session:
    frames_per_call = 1
    call_span = "frontend.process_frame"

    def __init__(self, cfg, traffic, seed, device):
        from feature_tracker_tpu_torch import pipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.pipeline = pipeline
        self.port_cfg = port_config(cfg)
        tex = frames.Texture(**cfg["texture"])
        self.ring = frames.render_ring(tex, cfg["height"], cfg["width"],
                                       traffic, seed, self.device)
        self.n_ring = len(self.ring)
        self.traced_frames = 0
        self.tracer = None
        self._work = {}

    def frame(self, position):
        return self.ring[frames.frame_index(self.traffic, self.n_ring,
                                            position)]

    def warm_up(self):
        fe = self.pipeline.TrackingFrontEnd(self.port_cfg, device=self.device)
        for k in range(int(self.traffic.get("warm_frames", 8))):
            fe.process_frame(self.frame(k))

    def start_window(self):
        self.fe = self.pipeline.TrackingFrontEnd(self.port_cfg,
                                                 device=self.device)
        if self.tracer is not None:
            self.fe.tracker.track = self.tracer.wrap(
                "tracker.track", self.fe.tracker.track, True)
        rng = random.Random(self.seed)
        self.sample = Reservoir(SAMPLE, rng)
        self.replenished = Reservoir(REPLENISHED, rng)
        self.first = None
        self.prev = None
        self.next_id = 0
        self.traced = []        # the items of the traced frames

    def call(self, i):
        return self.fe.process_frame(self.frame(i))

    def keep(self, i, result):
        """Offer frame ``i`` to the samples: with the result before it and
        the next id the port had to hand out before it (every id handed
        out appears in the result of its frame)."""
        item = (i, self.prev, result, self.next_id)
        if i == 0:
            self.first = item
        else:
            self.sample.offer(item)
        top = int(result.track_ids.max()) + 1
        if i > 0 and top > self.next_id:
            self.replenished.offer(item)
        self.next_id = max(self.next_id, top)
        if i < self.traced_frames:
            self.traced.append(item)
        self.prev = result

    def install_spans(self, tracer):
        """Spans around the pipeline's detection and pyramid (the names
        ``pipeline.py`` calls), the tracker's ``track`` (ending in a
        synchronise) and each ``process_frame`` call."""
        self.tracer = tracer
        self.traced_frames = int(self.traffic.get("trace_frames", 0))
        p = self.pipeline
        self._unpatched = (p.detect_good_features, p.build_pyramid)
        p.detect_good_features = tracer.wrap("pipeline.detect_good_features",
                                             p.detect_good_features, True)
        p.build_pyramid = tracer.wrap("pipeline.build_pyramid",
                                      p.build_pyramid)
        self.call = tracer.wrap(self.call_span, self.call)

    def finish(self):
        """Drop the port's state (after the window's memory peak is read)."""
        self.fe = None
        if self.tracer is not None:
            (self.pipeline.detect_good_features,
             self.pipeline.build_pyramid) = self._unpatched
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------

    def _image(self, position):
        return torch.as_tensor(self.frame(position), device=self.device)

    def reference_frame(self, item, dtype=torch.float32):
        """The reference's (uv, status, ids, num_live, steps) at the window
        frame of ``item``, from the port's state after the frame before it
        (from nothing at the first frame)."""
        i, prev, _, next_id = item
        if prev is None:
            return ref.frame(self.cfg, ref.FrontEndState(self.cfg["capacity"]),
                             None, self._image(i), dtype)
        state = ref.FrontEndState(self.cfg["capacity"], prev.uv,
                                  prev.track_ids, next_id)
        return ref.frame(self.cfg, state, self._image(i - 1), self._image(i),
                         dtype)

    def compare(self, control=False):
        """The compared numbers of the port (or, with ``control``, of the
        reference in bfloat16 in its place) against the reference, and the
        largest uv gap (``uv_gap_px``, not compared)."""
        items = {it[0]: it for it in [self.first, *self.sample.items,
                                      *self.replenished.items]}
        gap, off, both_n, status_diff, id_diff, lanes = 0.0, 0, 0, 0, 0, 0
        for _, item in sorted(items.items()):
            want = self.reference_frame(item)
            if control:
                got = self.reference_frame(item, torch.bfloat16)[:4]
            else:
                r = item[2]
                got = (r.uv, r.status, r.track_ids, r.num_live)
            both = (got[1] == ref.TRACKED) & (want[1] == ref.TRACKED)
            d = np.abs(got[0][both] - want[0][both]).max(axis=-1, initial=0)
            gap = max(gap, float(d.max(initial=0)))
            off += int((d > UV_TOLERANCE_PX).sum())
            both_n += int(both.sum())
            status_diff += int((got[1] != want[1]).sum())
            id_diff += int((got[2] != want[2]).sum())
            lanes += len(want[1])
        return {"uv_off_share": off / max(1, both_n),
                "status_mismatch": status_diff / lanes,
                "id_mismatch": id_diff / lanes, "uv_gap_px": gap}

    def verify(self):
        got = self.compare()
        return [(k, got[k], v) for k, v in LIMITS.items()]

    # -- work arithmetic of the traced frames -------------------------------

    def traced_work(self, calls):
        if calls not in self._work:
            self._work[calls] = self._traced_work(calls)
        return self._work[calls]

    def _traced_work(self, calls):
        """Per-frame operations and kernel 1's bytes and operations per
        launch over the first ``calls`` window frames (the traced ones):
        Gauss-Newton steps counted by the reference on ``WORK_SAMPLE`` of
        them, from the port's state."""
        cfg, klt = self.cfg, self.cfg["klt"]
        h, w = cfg["height"], cfg["width"]
        shapes, hh, ww = [], h, w
        for _ in range(cfg["pyramid_levels"]):
            shapes.append((hh, ww))
            hh, ww = hh // 2, ww // 2
        traced = self.traced[:calls]
        tracked = [it for it in traced if it[1] is not None]
        rng = random.Random(self.seed + 1)
        steps, lanes = [], []
        for item in rng.sample(tracked, min(WORK_SAMPLE, len(tracked))):
            lanes.append(int((item[1].track_ids >= 0).sum()))
            steps.append(self.reference_frame(item)[4])
        opts = {"patch_rows": 2 * klt["patch_row_half_size"] + 1,
                "patch_cols": 2 * klt["patch_col_half_size"] + 1}
        opts["ex_patch_rows"] = opts["patch_rows"] + 2
        opts["ex_patch_cols"] = opts["patch_cols"] + 2
        nbytes, klt_flops = work.klt_work(opts, shapes, cfg["capacity"],
                                          float(np.mean(lanes)),
                                          float(np.mean(steps)))
        # The frames that detected, by the detection span's calls.
        detections = sorted({c for c in self.tracer.calls.get(
            "pipeline.detect_good_features", ()) if c < calls})
        detect_flops = sum(
            work.shi_tomasi_flops(h, w, cfg["harris"]["window_half_size"],
                                  ref.candidates(self._image(i),
                                                 cfg["harris"]))
            for i in detections)
        n = max(1, len(traced))
        frame_flops = (work.pyramid_flops(h, w, cfg["pyramid_levels"])
                       + klt_flops * len(tracked) / n + detect_flops / n)
        return {"klt_bytes": nbytes, "klt_flops": klt_flops,
                "frame_flops": frame_flops, "detections": len(detections)}
