"""Carry state across from the JAX package, without importing it.

The KLT trackers have no learned weights, so what crosses is options, a
tracker's warp predictions and the front end's track state:

  opts = options_from_jax(jax_front_end.cfg)        # FrontEndConfig
  tracker = tracker_from_jax(jax_front_end.tracker, device="cuda")
  fe = TrackingFrontEnd(opts, tracker=tracker, device="cuda")
  fe.load_state_dict(front_end_state_from_jax(jax_front_end))

Objects are matched by dataclass name and field names; arrays cross as
numpy.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from feature_tracker_tpu_torch.core.config import (
    HarrisOptions,
    KltMethod,
    KltOptions,
    PyramidOptions,
)
from feature_tracker_tpu_torch.pipeline import FrontEndConfig
from feature_tracker_tpu_torch.trackers.klt import (
    AffineKlt,
    BasicKlt,
    LssdKlt,
)

_PORT_CONFIGS = {cls.__name__: cls for cls in
                 (KltOptions, HarrisOptions, PyramidOptions, FrontEndConfig)}


def options_from_jax(obj):
    """The port's counterpart of a JAX ``KltOptions``, ``HarrisOptions``,
    ``PyramidOptions`` or ``FrontEndConfig`` (nested configs included),
    built field by field; ``KltMethod`` crosses by its ``.value``."""
    if isinstance(obj, enum.Enum):
        if type(obj).__name__ != KltMethod.__name__:
            raise TypeError(f"no port counterpart for enum {type(obj)!r}")
        return KltMethod(obj.value)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    name = type(obj).__name__
    if name not in _PORT_CONFIGS:
        raise TypeError(f"no port counterpart for {type(obj)!r}")
    cls = _PORT_CONFIGS[name]
    theirs = {f.name for f in dataclasses.fields(obj)}
    ours = {f.name for f in dataclasses.fields(cls)}
    if theirs != ours:
        raise ValueError(f"{name} fields differ: only in JAX "
                         f"{sorted(theirs - ours)}, only in the port "
                         f"{sorted(ours - theirs)}")
    return cls(**{f: options_from_jax(getattr(obj, f)) for f in theirs})


def tracker_from_jax(jax_tracker, device="cuda"):
    """The port's ``BasicKlt`` / ``AffineKlt`` / ``LssdKlt`` for a JAX
    tracker, matched by class name: its options, its ``predict_affine`` or
    ``predict_rotation`` (as numpy) and ``consider_patch_luminance``."""
    name = type(jax_tracker).__name__
    if name not in ("BasicKlt", "AffineKlt", "LssdKlt"):
        raise TypeError(
            f"no port counterpart for tracker {type(jax_tracker)!r}")
    opts = options_from_jax(jax_tracker.options)
    if name == "BasicKlt":
        return BasicKlt(opts, device=device)
    if name == "AffineKlt":
        tracker = AffineKlt(opts, device=device)
        tracker.predict_affine = np.array(jax_tracker.predict_affine,
                                          np.float32)
        return tracker
    tracker = LssdKlt(opts, bool(jax_tracker.consider_patch_luminance),
                      device=device)
    tracker.predict_rotation = np.array(jax_tracker.predict_rotation,
                                        np.float32)
    return tracker


def front_end_state_from_jax(front_end) -> dict:
    """A JAX ``TrackingFrontEnd``'s track state in the layout of
    ``TrackingFrontEnd.state_dict`` (numpy arrays and ints)."""
    pyr = front_end._prev_pyr
    return {
        "uv": np.array(front_end._uv, np.float32),
        "ids": np.array(front_end._ids, np.int64),
        "dead": np.array(front_end._dead, bool),
        "next_id": int(front_end._next_id),
        "frame_id": int(front_end._frame_id),
        "prev_pyramid": None if pyr is None else tuple(
            np.asarray(l, np.float32) for l in pyr),
    }
