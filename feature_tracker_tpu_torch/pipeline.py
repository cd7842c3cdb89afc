"""Production tracking front end: detect -> pyramid -> track -> replenish.

The persistent front end a visual-SLAM system runs: fixed-capacity track
state, persistent track identities, and failure-aware replenishment (new
detections fill dead lanes, suppressed around surviving tracks).

Each frame builds its pyramid and tracks into it on the front end's
device (on CUDA, tracking is one launch of the KLT kernel); the
bookkeeping is O(capacity) numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import HarrisOptions, KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops.detect import detect_good_features
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import BasicKlt
from feature_tracker_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class FrontEndConfig:
    capacity: int = 300              # track slots (fixed shape)
    pyramid_levels: int = 4
    min_live_tracks: int = 150       # replenish below this
    replenish_suppression: float = 10.0  # px around surviving tracks
    klt: KltOptions = KltOptions(max_track_points=300)
    harris: HarrisOptions = HarrisOptions(min_feature_distance=25,
                                          min_valid_response=40.0)


@dataclasses.dataclass
class FrameResult:
    frame_id: int
    uv: np.ndarray          # [capacity, 2]
    status: np.ndarray      # [capacity] int8 (TRACKED = alive this frame)
    track_ids: np.ndarray   # [capacity] int64, -1 = empty lane
    num_live: int


class TrackingFrontEnd:
    """Persistent KLT front end over a frame stream."""

    def __init__(self, cfg: FrontEndConfig = FrontEndConfig(),
                 tracker=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracker = tracker or BasicKlt(cfg.klt, device=self.device)
        cap = cfg.capacity
        self._uv = np.zeros((cap, 2), np.float32)
        self._ids = np.full((cap,), -1, np.int64)
        self._dead = np.ones((cap,), bool)
        self._next_id = 0
        self._frame_id = -1
        self._prev_pyr = None

    @property
    def live_mask(self) -> np.ndarray:
        return ~self._dead

    def _replenish(self, img):
        uv, num = detect_good_features(img, self.cfg.capacity,
                                       self.cfg.harris, device=self.device)
        cand = uv.cpu().numpy()[:int(num)]
        count("host_syncs", 2)
        if cand.size == 0:
            return
        live = self._uv[~self._dead]
        if live.size:
            d2 = ((cand[:, None, :] - live[None, :, :]) ** 2).sum(-1)
            cand = cand[d2.min(axis=1)
                        > self.cfg.replenish_suppression ** 2]
        free = np.nonzero(self._dead)[0]
        take = min(len(free), len(cand))
        slots = free[:take]
        self._uv[slots] = cand[:take]
        self._ids[slots] = np.arange(self._next_id, self._next_id + take)
        self._next_id += take
        self._dead[slots] = False

    def _step(self, img):
        """Build the new frame's pyramid and track the live lanes into it."""
        pyr = build_pyramid(img, self.cfg.pyramid_levels, device=self.device)
        with span("frontend.upload"):
            dead = torch.as_tensor(self._dead, device=self.device)
            uv = torch.as_tensor(self._uv, device=self.device)
        status_in = torch.where(  # dead lanes are skipped
            dead, int(TrackStatus.OUTSIDE),
            int(TrackStatus.NOT_TRACKED)).to(torch.int8)
        uv_out, st = self.tracker.track(self._prev_pyr, pyr, uv, uv,
                                        status_in)
        return pyr, uv_out, st

    def process_frame(self, frame) -> FrameResult:
        """frame: [H, W] gray 0..255 (numpy or tensor). Returns the tracked
        state after this frame."""
        with span("frontend.frame"):
            return self._process(frame)

    def _process(self, frame) -> FrameResult:
        self._frame_id += 1
        with span("frontend.upload"):
            img = torch.as_tensor(frame, dtype=torch.float32,
                                  device=self.device)

        if self._prev_pyr is None:
            pyr = build_pyramid(img, self.cfg.pyramid_levels,
                                device=self.device)
            self._replenish(img)
            status = np.where(self._dead,
                              np.int8(int(TrackStatus.NOT_TRACKED)),
                              np.int8(int(TrackStatus.TRACKED)))
        else:
            pyr, uv_out, st = self._step(img)
            with span("frontend.readback"):
                status = st.cpu().numpy()
                self._uv = uv_out.cpu().numpy().copy()
            count("host_syncs", 2)
            failed = status != int(TrackStatus.TRACKED)
            self._dead |= failed
            self._ids[self._dead] = -1
            if (~self._dead).sum() < self.cfg.min_live_tracks:
                was_dead = self._dead.copy()
                self._replenish(img)
                # Slots filled by replenishment are alive THIS frame: fresh
                # detections carry TRACKED, like the first-frame branch.
                status = np.where(was_dead & ~self._dead,
                                  np.int8(int(TrackStatus.TRACKED)),
                                  status)

        self._prev_pyr = pyr
        return FrameResult(self._frame_id, self._uv.copy(), status,
                           self._ids.copy(),
                           int((~self._dead).sum()))

    def state_dict(self) -> dict:
        """The front end's state as numpy arrays and ints: ``uv``, ``ids``,
        ``dead``, ``next_id``, ``frame_id`` and ``prev_pyramid`` (a tuple
        of levels, or None before the first frame)."""
        pyr = None if self._prev_pyr is None else tuple(
            l.cpu().numpy() for l in self._prev_pyr)
        return {"uv": self._uv.copy(), "ids": self._ids.copy(),
                "dead": self._dead.copy(), "next_id": self._next_id,
                "frame_id": self._frame_id, "prev_pyramid": pyr}

    def load_state_dict(self, state: dict) -> None:
        """Resume from :meth:`state_dict`'s layout (also what
        ``convert.front_end_state_from_jax`` reads off a JAX front end)."""
        cap = self.cfg.capacity
        uv = np.array(state["uv"], np.float32)
        ids = np.array(state["ids"], np.int64)
        dead = np.array(state["dead"], bool)
        if uv.shape != (cap, 2) or ids.shape != (cap,) or dead.shape != (cap,):
            raise ValueError(
                f"state is for another capacity: uv {uv.shape}, ids "
                f"{ids.shape}, dead {dead.shape}; this front end holds {cap}")
        self._uv, self._ids, self._dead = uv, ids, dead
        self._next_id = int(state["next_id"])
        self._frame_id = int(state["frame_id"])
        pyr = state["prev_pyramid"]
        self._prev_pyr = None if pyr is None else tuple(
            torch.tensor(np.asarray(l), dtype=torch.float32,
                         device=self.device) for l in pyr)
