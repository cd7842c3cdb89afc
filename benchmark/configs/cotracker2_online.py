"""Session of the ``cotracker2_online`` configuration: the port's CoTracker2
at its published widths through ``CoTracker2Online.step``, the release's
online predictor: ``frames_per_call`` (4) host ``uint8`` RGB frames a call,
the tracks of the window of the last 8 frames on the card after a
synchronise, held to ``reference/cotracker2.py``. The weights are drawn
from the seed on the card (``reference.cotracker2.draw_weights``, the
release's initialisation) and loaded into the port.

Traffic: a ring of frames (``frames.py``, one texture a colour channel)
replayed in clips of ``clip_frames`` consecutive frames; a clip's first
call hands in its first 4 frames with a ``grid_size`` x ``grid_size`` grid
of queries on its first frame, placed as co-tracker's
``get_points_on_a_grid`` places them, and tracks nothing yet; every later
call of the clip runs one window.

What is compared (once the window has closed): ``CHECK_CALLS`` windowed
calls of the window drawn from the seed (a reservoir sample), each against
the plain float32 reference run on the same inputs: the 4 frames the call
was handed and the state the port carried into it (its last 4 frames, the
queries, the coordinates and visibility of the frames it shares with the
window before), with the query points' features sampled by the reference
itself from the clip's host frames (the port's are its own bfloat16
encoder's, so they are not taken): the timed path's own output at the
timed size, not the chaos of chained windows. The numbers
compared, of the endpoint distance between the port's tracks and the
reference's over a window's tracks and frames: its mean
(``track_gap_px``) and 99th percentile (``track_p99_gap_px``), and the
mean absolute gap of the visibility logits (``vis_logit_gap``), each the
largest over the sampled windows. Each limit lies between the port's
readings over a dozen seeds (lower) and the control's, the reference with
float8 e4m3 products in the port's place (upper); see ``PERF.md``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import frames
from benchmark.harness import Reservoir
from benchmark.reference import cotracker2 as ref
from benchmark.work import cotracker2 as cot_work

CHECK_CALLS = 16
LIMITS = {"track_gap_px": 0.125, "track_p99_gap_px": 0.33,
          "vis_logit_gap": 0.07}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(cfg):
    import dataclasses

    from feature_tracker_tpu_torch.models.cotracker2 import CoTracker2Config

    fields = {f.name for f in dataclasses.fields(CoTracker2Config)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["model_resolution"] = tuple(cfg["model_resolution"])
    kw["dtype"] = DTYPES[cfg["dtype"]]
    return CoTracker2Config(**kw)


def grid_queries(size, height, width):
    """co-tracker's ``get_points_on_a_grid(size, (height, width))`` on frame
    0: ``[size^2, 3]`` (t, x, y), a margin of ``width / 64``, row-major."""
    margin = width / 64
    ys = np.linspace(margin, height - margin, size, dtype=np.float32)
    xs = np.linspace(margin, width - margin, size, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([np.zeros(size * size, np.float32), gx.reshape(-1),
                     gy.reshape(-1)], -1)


def reference_state(st, track_feat):
    """The port's carried state (``OnlineState``) as the reference's, with
    ``track_feat``, the query points' features, in place of the port's."""
    return {"queries": st.queries, "frames": st.frames, "start": st.start,
            "coords": st.coords, "vis": st.vis, "track_feat": track_feat}


class Session:
    call_span = "cotracker2_online.call"

    def __init__(self, cfg, traffic, seed, device):
        from feature_tracker_tpu_torch.models.cotracker2 import (
            CoTracker2,
            CoTracker2Online,
        )

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.frames_per_call = int(traffic["frames_per_call"])
        self.calls_per_clip = int(traffic["clip_frames"]) // \
            self.frames_per_call
        height, width = cfg["model_resolution"]
        self.weights = ref.draw_weights(cfg, seed, self.device)
        model = CoTracker2(port_config(cfg), device=self.device)
        model.load_state_dict(self.weights)
        self.model = model
        self.online = CoTracker2Online(model)
        tex = cfg["texture"]
        self.ring = np.stack([frames.render_ring(
            frames.Texture(**dict(tex, seed=tex["seed"] + c)), height, width,
            traffic, seed, self.device) for c in range(3)], -1)
        self.queries = grid_queries(int(traffic["grid_size"]), height, width)
        self.tracer = None
        self.locations = []
        self._work = {}

    def chunk(self, i):
        """The host frames of window call ``i``: its clip's frames
        ``4 p .. 4 p + 3``, p the call's place in the clip."""
        clip, place = divmod(i, self.calls_per_clip)
        first = clip * self.calls_per_clip * self.frames_per_call
        idx = [frames.frame_index(self.traffic, len(self.ring),
                                  first + place * self.frames_per_call + k)
               for k in range(self.frames_per_call)]
        return np.ascontiguousarray(self.ring[idx])

    def clip_frame(self, i, t):
        """Host frame ``t`` of the clip that call ``i`` belongs to."""
        first = i // self.calls_per_clip * self.calls_per_clip \
            * self.frames_per_call
        return self.ring[frames.frame_index(self.traffic, len(self.ring),
                                            first + t)]

    def query_features(self, fn, i, st):
        """The query points' features that the state ``st`` carries into
        window call ``i``, as the reference ``fn`` samples them from the
        clip's host frames: those of the queries on frames before
        ``st.start + window_len / 2``, none before a clip's first window
        (the release's ``get_track_feat``, one frame a query)."""
        q = st.queries
        feat = torch.zeros((q.shape[0], self.cfg["latent_dim"]),
                           device=self.device)
        qf = q[:, 0].long()
        have = qf < st.start + self.cfg["window_len"] // 2
        if st.start == 0 or not bool(have.any()):
            return feat
        used = torch.unique(qf[have])
        host = np.stack([self.clip_frame(i, t) for t in used.tolist()])
        with ref.no_tf32():
            fmaps = fn.encode(host)
            feat[have] = fn.track_features(
                fmaps, torch.searchsorted(used, qf[have]),
                q[have, 1:] / self.cfg["stride"])
        return feat

    def runs_window(self, i):
        return i % self.calls_per_clip != 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm_up(self):
        """A clip's first three calls: the queries, the first window and a
        later one (the carried state's path)."""
        for i in range(3):
            self._step(i)
        self._sync()

    def start_window(self):
        self.kept = Reservoir(CHECK_CALLS, random.Random(self.seed))

    def _step(self, i):
        host = self.chunk(i)
        if not self.runs_window(i):
            self.online.step(host, self.queries)
            return None
        before = self.online.state
        return before, host, self.online.step(host)

    def call(self, i):
        out = self._step(i)
        self._sync()
        return out

    def keep(self, i, out):
        if out is not None:
            self.kept.offer((i, out))

    def install_spans(self, tracer):
        """Spans from forward hooks (each after a synchronise) on the
        encoder and the former, around each lookup (recording the first
        window's locations for the work arithmetic) and each call."""
        self.tracer = tracer
        m = self.model
        tracer.hook(m.fnet, "cotracker2_online.fnet")
        tracer.hook(m.updateformer, "cotracker2_online.updateformer")
        lookup = m.lookup_fn

        def recorded(fmap0, pyr, locations, radius, padding="zeros"):
            if not self.locations or self.locations[0][0] == tracer.call:
                self.locations.append(
                    (tracer.call, tuple(fmap0.shape),
                     [tuple(p.shape) for p in pyr],
                     locations.detach().clone(), radius))
            return lookup(fmap0, pyr, locations, radius, padding)

        m.lookup_fn = tracer.wrap("cotracker2_online.lookup", recorded)
        self.call = tracer.wrap(self.call_span, self.call)

    def finish(self):
        """Drop the port's model (after the window's memory peak is read)."""
        self.model = self.online.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------

    def compare(self, control=False):
        """Per sampled window: the mean and the 99th percentile over its
        tracks and frames of the endpoint distance to the reference's
        tracks, and the mean absolute gap of the visibility logits; the
        port's outputs, or with ``control`` the float8 reference's in
        their place. Each reference window starts from the state the port
        carried into the call, with the query points' features that the
        reference (or the control) samples itself."""
        want_fn = ref.CoTracker2Reference(self.weights, self.cfg, self.device)
        got_fn = (ref.CoTracker2Reference(self.weights, self.cfg,
                                          self.device, fp8=True)
                  if control else None)
        means, p99s, vis_gaps = [], [], []
        for i, (before, host, (tracks, vis)) in sorted(
                self.kept.items, key=lambda kv: kv[0]):
            state = reference_state(before, self.query_features(
                want_fn, i, before))
            want_tracks, want_vis = want_fn.online_step(state, host)[0]
            if control:
                state = reference_state(before, self.query_features(
                    got_fn, i, before))
                tracks, vis = got_fn.online_step(state, host)[0]
            d = torch.linalg.vector_norm(tracks.float() - want_tracks, dim=-1)
            means.append(float(d.mean()))
            p99s.append(float(torch.quantile(d.flatten(), 0.99)))
            vis_gaps.append(float((vis.float() - want_vis).abs().mean()))
        return {"track_gap_px": max(means), "track_p99_gap_px": max(p99s),
                "vis_logit_gap": max(vis_gaps)}

    def verify(self):
        got = self.compare()
        return [(k, got[k], v) for k, v in LIMITS.items()]

    # -- work arithmetic of the traced calls ---------------------------------

    def traced_work(self, calls):
        if calls not in self._work:
            self._work[calls] = self._traced_work()
        return self._work[calls]

    def _traced_work(self):
        """Kernel 5's bytes and FLOPs per launch (border mode) on the first
        traced window's own lookup locations, and the FLOPs of a call that
        runs a window."""
        looks = [cot_work.lookup_work_border(f0, pyr, locs, r)
                 for _, f0, pyr, locs, r in self.locations]
        if not looks:
            return None
        nbytes = float(np.mean([b for b, _ in looks]))
        flops = float(np.mean([f for _, f in looks]))
        window = cot_work.call_flops(self.cfg, len(self.queries), flops)
        return {"lookup_bytes": nbytes, "lookup_flops": flops,
                "window_call_flops": window}

    def calls_flops(self, calls, first, last):
        """FLOPs of window calls ``first .. last - 1``: a call that runs a
        window does ``window_call_flops``, a clip's first call none worth
        counting (it keeps the frames and the queries)."""
        w = self.traced_work(calls)
        if w is None:
            return None
        return w["window_call_flops"] * sum(
            self.runs_window(i) for i in range(first, last))

