"""Session of the ``superpoint_lightglue`` configuration: the port's
SuperPoint and LightGlue on the repository's weights at the release's
working size, frame to frame. A call takes one new host ``uint8`` frame:
``SuperPointDetector.detect`` on it (2048 keypoints at most, threshold
0.0005, radius 4; on the card kernel 6 suppresses), then
``NNFeatureMatcher.match`` of the previous frame's cached keypoints,
descriptors and mask against the new frame's (LightGlue's 9 layers at 2048
x 2048, the filter at ``ln 0.1``), and ends when ``matched_uv`` and
``status`` are ready on the card after a synchronise. The mask is made from
``num`` on the card; nothing on the path reads the device. The stream's
first frame only detects, in set-up. Each call is one span of the port's
tracer (``superpoint_lightglue.frame``), so that the port's tracer counts
one call a frame, as it does for the entry points of the other
configurations.

Traffic: a ring of frames (``frames.py``) replayed forward and back.

What is compared (once the window has closed): ``CHECK_CALLS`` calls of the
window drawn from the seed (a reservoir sample), each from the state the
port carried into it, against the plain float32 reference
(``reference/superpoint_lightglue.py``), which reads the weight files
itself. The port's heatmap, dense descriptors, log-assignment and
matchability logits are those of the timed call (forward hooks keep them):

- ``heatmap_gap``: largest absolute gap of the heatmap to the reference's
  on the same frame;
- ``dense_desc_gap``: largest absolute gap of the dense descriptors;
- ``keypoint_mismatch``: slots of ``uv`` that differ from the reference's
  selection on the port's own heatmap, plus the gap of the counts (exact:
  the selection is integer work on the same scores);
- ``desc_gap``: largest absolute gap of the port's keypoint descriptors to
  the reference's samples of its own dense map at the port's keypoints;
- ``score_gap_mean``, ``score_gap_p99``: the mean and the 99th percentile
  of the absolute gap of the log-assignment over the valid pairs, against
  the reference's LightGlue on the port's keypoints, descriptors and masks
  of both frames;
- ``logit_gap``: largest absolute gap of a valid point's matchability
  logit;
- ``match_row_share``: share of the previous frame's valid points whose
  match (``status`` and ``matched_uv``) differs from the reference's
  mutual best match at the filter.

Each number is the worst over the sampled calls. Each limit lies between
the port's readings over a dozen seeds (lower) and the control's, the
reference computed in bfloat16 in the port's place (upper; see
``PERF.md``); ``calibrate.py`` prints both.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from benchmark import frames
from benchmark.harness import ROOT, Reservoir
from benchmark.reference import superpoint_lightglue as ref
from benchmark.work import superpoint_lightglue as sp_work

CHECK_CALLS = 8
# Limits of ``correct``: each lies between the port's largest reading on
# the card and the bfloat16 control's least (25 readings of the port, 6 of
# the control; PERF.md), 60 times or more from either but for
# ``match_row_share`` (8 and 2.9). The port computes in float32 with TF32
# off, so its gaps are float32's rounding summed in another order.
LIMITS = {
    "heatmap_gap": 1e-4,        # port <= 1.7e-6, control >= 0.048
    "dense_desc_gap": 1e-3,     # port <= 1.7e-5, control >= 0.48
    # The selection is integer work on the port's own scores: exact.
    "keypoint_mismatch": 0,
    "desc_gap": 1e-4,           # port <= 4.3e-7, control >= 0.015
    "score_gap_mean": 2e-3,     # port <= 2.4e-5, control >= 0.20
    "score_gap_p99": 5e-3,      # port <= 8.1e-5, control >= 0.65
    "logit_gap": 1e-3,          # port <= 1.3e-5, control >= 0.094
    # A row's match flips only where two candidates nearly tie: one row in
    # 2048 (4.9e-4) in 1 of 25 readings; the control >= 0.0117.
    "match_row_share": 0.004,
}


class Session:
    call_span = "superpoint_lightglue.call"
    frames_per_call = 1

    def __init__(self, cfg, traffic, seed, device):
        from feature_tracker_tpu_torch.match.nn_matcher import (
            NNFeatureMatcher,
            NNMatcherModelType,
            NNMatcherOptions,
        )
        from feature_tracker_tpu_torch.models.superpoint import (
            SuperPointDetector,
        )
        from feature_tracker_tpu_torch.utils import profiling

        if cfg["depth_confidence"] != -1 or cfg["width_confidence"] != -1 \
                or cfg["dtype"] != "float32":
            raise ValueError("the port runs LightGlue without adaptive depth "
                             "or width, in float32")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.profiling = profiling
        self.paths = {k: os.path.join(ROOT, v)
                      for k, v in cfg["weights"].items()}
        self.k = int(cfg["max_num_keypoints"])
        self.detector = SuperPointDetector.from_file(
            self.paths["superpoint"], max_features=self.k,
            min_response=cfg["detection_threshold"],
            min_feature_distance=cfg["nms_radius"], device=self.device)
        self.matcher = NNFeatureMatcher.from_file(
            NNMatcherOptions(
                max_number_of_matches=self.k,
                min_valid_match_score=math.log(cfg["filter_threshold"]),
                model_type=NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT,
                depth=cfg["n_layers"]),
            path=self.paths["lightglue"], device=self.device)
        if self.detector is None or self.matcher is None:
            raise FileNotFoundError(f"weights missing: {self.paths}")
        lg = self.matcher.cfg
        if (lg.model_dim, lg.num_heads, lg.descriptor_dim) != (
                cfg["descriptor_dim"], cfg["num_heads"], cfg["input_dim"]):
            raise ValueError(f"the port's LightGlue is {lg}")
        height, width = cfg["image_size"]
        self.ring = frames.render_ring(frames.Texture(**cfg["texture"]),
                                       height, width, traffic, seed,
                                       self.device)
        self.warm = int(traffic.get("warm_frames", 3))
        # The timed call's own model outputs, for the comparison.
        self.seen = {}
        for name, model in (("superpoint", self.detector.model),
                            ("lightglue", self.matcher.model)):
            model.register_forward_hook(self._keeper(name))
        self.state = None

    def _keeper(self, name):
        def hook(_module, _args, out):
            self.seen[name] = out
        return hook

    def frame(self, position):
        """Host frame of the stream's ``position``-th frame."""
        return self.ring[frames.frame_index(self.traffic, len(self.ring),
                                            position)]

    def _features(self, position):
        uv, desc, num = self.detector.detect(self.frame(position))
        mask = torch.arange(uv.shape[0], device=uv.device) < num
        return uv, desc, mask

    def _step(self, position):
        """One frame: detect, then match the carried features to it."""
        with self.profiling.span("superpoint_lightglue.frame"):
            before = self.state
            now = self._features(position)
            matched_uv, status = self.matcher.match(
                before[1], now[1], before[0], now[0], before[2], now[2])
            self.state = now
        return position, before, now, matched_uv, status

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm_up(self):
        """The stream's first frame (detection only) and the frames after
        it up to ``warm_frames``."""
        self.state = self._features(0)
        for position in range(1, self.warm):
            self._step(position)
        self._sync()

    def start_window(self):
        self.kept = Reservoir(CHECK_CALLS, random.Random(self.seed))

    def call(self, i):
        out = self._step(self.warm + i)
        self._sync()
        return out

    def keep(self, i, out):
        self.kept.offer((i, out, dict(self.seen)))

    def install_spans(self, tracer):
        """Spans from forward hooks (each after a synchronise) on SuperPoint
        and LightGlue, and around each call."""
        tracer.hook(self.detector.model, "superpoint_lightglue.superpoint")
        tracer.hook(self.matcher.model, "superpoint_lightglue.lightglue")
        self.call = tracer.wrap(self.call_span, self.call)

    def finish(self):
        """Drop the port's models (after the window's memory peak is
        read)."""
        self.detector = self.matcher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def call_flops(self):
        """FLOPs of one call (``work/superpoint_lightglue.py``)."""
        return sp_work.call_flops(self.cfg)

    # -- the reference --------------------------------------------------------

    def compare(self, control=False):
        """The numbers of the module's docstring, each the worst over the
        sampled calls: the port's, or with ``control`` the bfloat16
        reference's in the port's place (its own heatmap, dense map,
        keypoints and keypoint descriptors on the same frame; its
        LightGlue on the port's features)."""
        from feature_tracker_tpu_torch.core.status import TrackStatus

        cfg = self.cfg
        sp_vars = ref.load_variables(self.paths["superpoint"])
        lg_vars = ref.load_variables(self.paths["lightglue"])
        sp_want = ref.SuperPointReference(sp_vars, self.device)
        lg_want = ref.LightGlueReference(lg_vars, self.device,
                                         heads=cfg["num_heads"])
        if control:
            sp_got = ref.SuperPointReference(sp_vars, self.device,
                                             torch.bfloat16)
            lg_got = ref.LightGlueReference(lg_vars, self.device,
                                            torch.bfloat16,
                                            heads=cfg["num_heads"])
        select = dict(max_num=self.k,
                      min_response=cfg["detection_threshold"],
                      radius=cfg["nms_radius"])
        worst = dict.fromkeys(LIMITS, 0.0)

        def note(name, value):
            worst[name] = max(worst[name], float(value))

        for _, out, seen in sorted(self.kept.items, key=lambda kv: kv[0]):
            position, before, now, matched_uv, status = out
            frame = self.frame(position)
            heat_want, dmap_want = sp_want.forward(frame)
            uv, desc, mask = now
            if control:
                heat, dmap = sp_got.forward(frame)
                got_uv, got_num = ref.select_keypoints(heat, **select)
                uv = torch.as_tensor(got_uv, device=self.device)
                mask = torch.arange(self.k, device=self.device) < got_num
                desc = ref.describe(dmap, uv)
            else:
                heat, dmap = (t[0] for t in seen["superpoint"])
            note("heatmap_gap", (heat - heat_want).abs().max())
            note("dense_desc_gap", (dmap - dmap_want).abs().max())
            want_uv, want_num = ref.select_keypoints(heat, **select)
            note("keypoint_mismatch",
                 np.any(uv.cpu().numpy() != want_uv, axis=1).sum()
                 + abs(int(mask.sum()) - want_num))
            if bool(mask.any()):
                note("desc_gap", (desc - ref.describe(dmap_want, uv))
                     .abs()[mask].max())

            # LightGlue on the port's features of both frames.
            (uv0, desc0, mask0), (uv1, desc1, mask1) = before, now
            want = lg_want.forward(uv0, desc0, mask0, uv1, desc1, mask1)
            if control:
                got_lg = lg_got.forward(uv0, desc0, mask0, uv1, desc1, mask1)
                idx = ref.mutual_matches(got_lg[0], cfg["filter_threshold"])
                found = idx >= 0
                matched_uv = uv1[idx.clamp(min=0)]
            else:
                got_lg = seen["lightglue"]
                found = status.long() == int(TrackStatus.TRACKED)
            pair = mask0[:, None] & mask1[None, :]
            if bool(pair.any()):
                gap = (got_lg[0] - want[0]).abs()[pair]
                note("score_gap_mean", gap.mean())
                note("score_gap_p99", torch.quantile(gap, 0.99))
            for got_logit, want_logit, m in ((got_lg[1], want[1], mask0),
                                             (got_lg[2], want[2], mask1)):
                if bool(m.any()):
                    note("logit_gap", (got_logit - want_logit).abs()[m].max())
            idx_want = ref.mutual_matches(want[0], cfg["filter_threshold"])
            found_want = idx_want >= 0
            differ = (found != found_want) | (
                found & found_want
                & (matched_uv != uv1[idx_want.clamp(min=0)]).any(-1))
            if bool(mask0.any()):
                note("match_row_share", differ[mask0].float().mean())
        return worst

    def verify(self):
        got = self.compare()
        return [(k, got[k], v) for k, v in LIMITS.items()]
