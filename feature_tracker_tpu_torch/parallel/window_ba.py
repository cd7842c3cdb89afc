"""Sliding-window keyframe back end over the sharded bundle adjuster.

The glue between the trackers and parallel/ba.py (the reference stops at
per-pair tracking): a fixed-capacity keyframe window plus a
fixed-capacity landmark table, fed from per-frame track results,
periodically refined with the Schur-complement BA, with
marginalization-by-drop when the window slides.

Capacity semantics: all arrays are static-size; liveness is carried by
masks. A landmark's observation list is a ring of the most recent
``obs_per_landmark`` sightings. The bookkeeping is the JAX package's numpy
code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from feature_tracker_tpu_torch.parallel.ba import (
    BaOptions,
    _ba_device,
    bundle_adjust,
)
from feature_tracker_tpu_torch.parallel.sharded import (
    _gather_features,
    shard_features,
)


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    max_keyframes: int = 8
    max_landmarks: int = 512
    obs_per_landmark: int = 8


class SlidingWindowBa:
    """Host-side bookkeeping + device-side optimization.

    The observation/landmark state is numpy (irregular per-frame updates
    are host work); ``optimize()`` ships the fixed-size arrays to the
    window's device (``"cuda"`` by default, the mesh's with a mesh; without
    a GPU this raises unless it is ``"cpu"``), landmarks sharded over the
    mesh's ranks when one is given, and runs the BA.
    """

    def __init__(self, k4, cfg: WindowConfig = WindowConfig(),
                 ba_options: BaOptions = BaOptions(), mesh=None,
                 device=None):
        self.cfg = cfg
        self.k4 = np.asarray(k4, np.float32)
        self.ba_options = ba_options
        self.mesh = mesh
        self.device = _ba_device(mesh, device)

        kf, lm, obs = cfg.max_keyframes, cfg.max_landmarks, \
            cfg.obs_per_landmark
        self.q_cw = np.tile(np.array([1, 0, 0, 0], np.float32), (kf, 1))
        self.t_cw = np.zeros((kf, 3), np.float32)
        self.kf_alive = np.zeros((kf,), bool)
        self.landmarks = np.zeros((lm, 3), np.float32)
        self.lm_alive = np.zeros((lm,), bool)
        self.obs_pose = np.zeros((lm, obs), np.int32)
        self.obs_uv = np.zeros((lm, obs, 2), np.float32)
        self.obs_mask = np.zeros((lm, obs), bool)
        self._obs_next = np.zeros((lm,), np.int32)
        self._next_kf = 0

    # ------------------------------------------------------------ intake
    def add_keyframe(self, q_cw, p_cw) -> int:
        """Insert a keyframe pose; slides the window (dropping the oldest
        keyframe and its observations) when full. Returns the slot."""
        if self._next_kf >= self.cfg.max_keyframes:
            self._slide()
        slot = self._next_kf
        self.q_cw[slot] = np.asarray(q_cw, np.float32)
        self.t_cw[slot] = np.asarray(p_cw, np.float32)
        self.kf_alive[slot] = True
        self._next_kf += 1
        return slot

    def _slide(self):
        """Drop keyframe 0, shift the window left (marginalization by
        drop: the oldest pose's observations are discarded)."""
        self.q_cw[:-1] = self.q_cw[1:]
        self.t_cw[:-1] = self.t_cw[1:]
        self.kf_alive[-1] = False
        hit = self.obs_pose == 0
        self.obs_mask &= ~hit
        self.obs_pose = np.maximum(self.obs_pose - 1, 0)
        self._next_kf -= 1

    def add_landmark(self, p_w) -> int:
        free = np.nonzero(~self.lm_alive)[0]
        if free.size == 0:
            raise RuntimeError("landmark table full")
        slot = int(free[0])
        self.landmarks[slot] = np.asarray(p_w, np.float32)
        self.lm_alive[slot] = True
        self.obs_mask[slot] = False
        self._obs_next[slot] = 0
        return slot

    def add_observation(self, lm_slot: int, kf_slot: int, uv):
        o = int(self._obs_next[lm_slot]) % self.cfg.obs_per_landmark
        self.obs_pose[lm_slot, o] = kf_slot
        self.obs_uv[lm_slot, o] = np.asarray(uv, np.float32)
        self.obs_mask[lm_slot, o] = True
        self._obs_next[lm_slot] += 1

    # ---------------------------------------------------------- optimize
    def optimize(self):
        """Run the (optionally sharded) Schur-complement BA over the
        window; writes refined poses/landmarks back. Returns the rms
        history array."""
        mask = self.obs_mask & self.lm_alive[:, None]
        arrays = (self.landmarks, self.obs_pose, self.obs_uv, mask)
        if self.mesh is not None:
            _, *arrays = shard_features(self.mesh, *arrays)
        q, t, new_lm, rms = bundle_adjust(
            self.q_cw, self.t_cw, *arrays, self.k4, self.ba_options,
            self.mesh, self.device)
        if self.mesh is not None:
            new_lm = _gather_features(self.mesh, new_lm,
                                      self.cfg.max_landmarks)
        self.q_cw = q.cpu().numpy()
        self.t_cw = t.cpu().numpy()
        self.landmarks = new_lm.cpu().numpy()
        return rms.cpu().numpy()
