"""Carry state across from the JAX package, without importing it.

The trackers and classical matchers have no learned weights, so what
crosses for them is options, a tracker's warp predictions and the front
end's track state:

  opts = options_from_jax(jax_front_end.cfg)        # FrontEndConfig
  tracker = tracker_from_jax(jax_front_end.tracker, device="cuda")
  fe = TrackingFrontEnd(opts, tracker=tracker, device="cuda")
  fe.load_state_dict(front_end_state_from_jax(jax_front_end))
  pose = tracker_from_jax(jax_direct_method, device="cuda")   # DirectMethod
  flow = tracker_from_jax(jax_dense_flow, device="cuda")  # DenseOpticalFlow
  matcher_opts = options_from_jax(jax_matcher_options)     # MatcherOptions

The sliding-window back end crosses with its options, its configuration
and its numpy state:

  window = sliding_window_from_jax(jax_window, device="cuda")
  opts = ba_options_from_jax(jax_ba_options)

The neural models' weights cross as a Flax variables tree of numpy
arrays, one converter per model (``raft_state_from_jax``,
``superpoint_state_from_jax``, ``disk_state_from_jax``,
``lightglue_state_from_jax``, ``cotracker_state_from_jax``):

  model = Raft(options_from_jax(jax_cfg), device="cuda")
  model.load_state_dict(raft_state_from_jax(variables))

Training state crosses too, so that both sides can start a step from the
same state: a RAFT trainer's ``TrainState`` (``train_state_from_jax``),
a SuperPoint, DISK or LightGlue trainer's ``(params, opt_state)``
(``model_train_state_from_jax``) and the CoTracker trainer's ``(params,
ema, opt_state)`` (``cotracker_train_state_from_jax``), optax's Adam
moments in the layout of the parameters they belong to:

  state = train_state_from_jax(jax_state, device="cuda")
  params, opt_state = model_train_state_from_jax(variables, jax_opt_state)

The way back, a port model's ``state_dict`` as the Flax variables tree the
JAX package's weight files hold, is ``flax_variables_from_state``.

Objects are matched by dataclass name and field names; arrays cross as
numpy.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Mapping

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import (
    HarrisOptions,
    KltMethod,
    KltOptions,
    PyramidOptions,
)
from feature_tracker_tpu_torch.match.matcher import MatcherOptions
from feature_tracker_tpu_torch.match.nn_matcher import (
    NNMatcherModelType,
    NNMatcherOptions,
)
from feature_tracker_tpu_torch.models.cotracker import CoTrackerConfig
from feature_tracker_tpu_torch.models.disk import DiskConfig
from feature_tracker_tpu_torch.models.lightglue import LightGlueConfig
from feature_tracker_tpu_torch.models.raft import RaftConfig
from feature_tracker_tpu_torch.models.superpoint import SuperPointConfig
from feature_tracker_tpu_torch.parallel.ba import BaOptions
from feature_tracker_tpu_torch.parallel.window_ba import (
    SlidingWindowBa,
    WindowConfig,
)
from feature_tracker_tpu_torch.pipeline import FrontEndConfig
from feature_tracker_tpu_torch.trackers.dense import (
    DenseFlowOptions,
    DenseOpticalFlow,
)
from feature_tracker_tpu_torch.trackers.direct import (
    DirectMethod,
    DirectMethodMode,
    DirectMethodOptions,
)
from feature_tracker_tpu_torch.trackers.klt import (
    AffineKlt,
    BasicKlt,
    LssdKlt,
)
from feature_tracker_tpu_torch.train.raft_train import TrainState

_PORT_CONFIGS = {cls.__name__: cls for cls in
                 (KltOptions, HarrisOptions, PyramidOptions, FrontEndConfig,
                  RaftConfig, MatcherOptions, DirectMethodOptions,
                  DenseFlowOptions, SuperPointConfig, DiskConfig,
                  LightGlueConfig, NNMatcherOptions, CoTrackerConfig,
                  BaOptions, WindowConfig)}
_PORT_ENUMS = {cls.__name__: cls for cls in (KltMethod, DirectMethodMode,
                                             NNMatcherModelType)}


def options_from_jax(obj):
    """The port's counterpart of a JAX ``KltOptions``, ``HarrisOptions``,
    ``PyramidOptions``, ``FrontEndConfig``, ``RaftConfig``,
    ``MatcherOptions``, ``DirectMethodOptions``, ``DenseFlowOptions``,
    ``SuperPointConfig``, ``DiskConfig``, ``LightGlueConfig``,
    ``NNMatcherOptions``, ``CoTrackerConfig``, ``BaOptions`` or
    ``WindowConfig`` (nested configs included),
    built field by field; ``KltMethod``, ``DirectMethodMode`` and
    ``NNMatcherModelType`` cross by their ``.value``, a float dtype by its
    name."""
    if isinstance(obj, enum.Enum):
        if type(obj).__name__ not in _PORT_ENUMS:
            raise TypeError(f"no port counterpart for enum {type(obj)!r}")
        return _PORT_ENUMS[type(obj).__name__](obj.value)
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
    values = {f: options_from_jax(getattr(obj, f)) for f in theirs}
    if "dtype" in values:
        values["dtype"] = getattr(torch, np.dtype(values["dtype"]).name)
    return cls(**values)


def _named(obj, name: str):
    if type(obj).__name__ != name:
        raise TypeError(f"expected a JAX {name}, got {type(obj)!r}")
    return options_from_jax(obj)


def ba_options_from_jax(opts) -> BaOptions:
    """The port's ``BaOptions`` for a JAX ``parallel.ba.BaOptions``."""
    return _named(opts, "BaOptions")


def window_config_from_jax(cfg) -> WindowConfig:
    """The port's ``WindowConfig`` for a JAX
    ``parallel.window_ba.WindowConfig``."""
    return _named(cfg, "WindowConfig")


_WINDOW_ARRAYS = ("q_cw", "t_cw", "kf_alive", "landmarks", "lm_alive",
                  "obs_pose", "obs_uv", "obs_mask", "_obs_next")


def sliding_window_from_jax(jax_window, device=None,
                            mesh=None) -> SlidingWindowBa:
    """The port's ``SlidingWindowBa`` in the state of a JAX one: its
    intrinsics, configuration, BA options, keyframes, landmarks, the
    observation ring and its cursors (the JAX window's mesh is not
    carried; pass the port's own)."""
    window = SlidingWindowBa(jax_window.k4,
                             window_config_from_jax(jax_window.cfg),
                             ba_options_from_jax(jax_window.ba_options),
                             mesh=mesh, device=device)
    for name in _WINDOW_ARRAYS:
        mine = getattr(window, name)
        setattr(window, name,
                np.array(getattr(jax_window, name), dtype=mine.dtype))
    window._next_kf = int(jax_window._next_kf)
    return window


def tracker_from_jax(jax_tracker, device="cuda"):
    """The port's ``BasicKlt`` / ``AffineKlt`` / ``LssdKlt`` /
    ``DirectMethod`` / ``DenseOpticalFlow`` for a JAX tracker, matched by
    class name: its options, its ``predict_affine`` or ``predict_rotation``
    (as numpy) and ``consider_patch_luminance``."""
    name = type(jax_tracker).__name__
    if name not in ("BasicKlt", "AffineKlt", "LssdKlt", "DirectMethod",
                    "DenseOpticalFlow"):
        raise TypeError(
            f"no port counterpart for tracker {type(jax_tracker)!r}")
    opts = options_from_jax(jax_tracker.options)
    if name == "DirectMethod":
        return DirectMethod(opts, device=device)
    if name == "DenseOpticalFlow":
        return DenseOpticalFlow(opts, device=device)
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


# A Flax leaf's name as a ``state_dict`` name.
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def flax_leaf_paths(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested mapping in Flax's flatten order
    (keys sorted at every level)."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    return [pair for key in sorted(tree)
            for pair in flax_leaf_paths(tree[key], prefix + (key,))]


def _torch_layout(arr, path, where):
    """A Flax leaf in the layout of its torch parameter: convolution
    kernels HWIO -> OIHW, ``Dense`` kernels ``[in, out]`` -> ``[out, in]``,
    attention ``DenseGeneral`` kernels ``[D, H, Dh]`` -> ``[H*Dh, D]`` (and
    the output's ``[H, Dh, D]`` -> ``[D, H*Dh]``), their ``[H, Dh]`` biases
    flattened."""
    if path[-1] == "kernel":
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 3 and path[-2] == "out":
            return arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 3:
            return arr.reshape(arr.shape[0], -1).T
        raise ValueError(f"leaf {where}: kernel of shape {arr.shape}, "
                         "expected 2, 3 or 4 axes")
    if path[-1] == "bias" and arr.ndim == 2:
        return arr.reshape(-1)
    return arr


def flax_leaves_from_jax(variables, model: str = "Flax"):
    """``(leaf path, state_dict key, tensor)`` for every leaf of a Flax
    variables tree of one of the port's models (``model`` names it in
    errors); see :func:`flax_state_from_jax`."""
    for path, leaf in flax_leaf_paths(variables):
        where = "/".join(path)
        if (len(path) < 3 or path[0] not in ("params", "batch_stats")
                or path[-1] not in _LEAF_NAMES):
            raise ValueError(f"unexpected leaf {where} in {model} variables")
        arr = _torch_layout(np.array(leaf, np.float32), path, where)
        key = ".".join(path[1:-1]) + "." + _LEAF_NAMES[path[-1]]
        # A copy the tensor may own.
        yield where, key, torch.from_numpy(np.ascontiguousarray(arr).copy())


def flax_state_from_jax(variables, model: str = "Flax") -> dict:
    """A Flax variables tree (``{"params": ..., "batch_stats": ...}``,
    nested mappings of arrays) as the ``state_dict`` of the port's model:
    a leaf's path under its collection is its key, kernels take torch's
    layout (:func:`_torch_layout`), ``scale`` / ``mean`` / ``var`` become
    ``weight`` / ``running_mean`` / ``running_var``, and every batch norm
    gets a zero ``num_batches_tracked``."""
    state = {}
    for _, key, tensor in flax_leaves_from_jax(variables, model):
        state[key] = tensor
        if key.endswith(".running_mean"):
            state[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
    return state


def _flax_layout(arr, parts, leaf, num_heads):
    """``(Flax leaf name, array)`` of a ``state_dict`` entry: the inverse
    of :func:`_torch_layout`. A query / key / value / out projection of a
    ``MultiHeadDotProductAttention_*`` module takes its ``[D, H, Dh]`` /
    ``[H, Dh, D]`` kernel and ``[H, Dh]`` bias from ``num_heads``."""
    attention = (len(parts) >= 2 and parts[-1] in ("query", "key", "value",
                                                  "out")
                 and parts[-2].startswith("MultiHeadDotProductAttention"))
    if attention and num_heads is None:
        raise ValueError(f"{'.'.join(parts)}: an attention leaf needs "
                         "num_heads")
    if leaf in ("running_mean", "running_var"):
        return leaf[len("running_"):], arr
    if leaf == "bias":
        if attention and parts[-1] != "out":
            return "bias", arr.reshape(num_heads, -1)
        return "bias", arr
    if arr.ndim == 1:
        return "scale", arr
    if arr.ndim == 4:
        return "kernel", arr.transpose(2, 3, 1, 0)
    if attention and parts[-1] == "out":
        return "kernel", arr.T.reshape(num_heads, -1, arr.shape[0])
    if attention:
        return "kernel", arr.T.reshape(arr.shape[1], num_heads, -1)
    return "kernel", arr.T


def flax_variables_from_state(state: dict, num_heads: int | None = None
                              ) -> dict:
    """The Flax variables tree of one of the port's models' ``state_dict``
    (or a dict of some of its entries): the inverse of
    :func:`flax_state_from_jax`, as the JAX package's weight files hold it
    (``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
    arrays; a collection without entries is left out; attention kernels
    need the model's ``num_heads``). ``num_batches_tracked`` is dropped."""
    tree = {}
    for key, value in state.items():
        *parts, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        name, arr = _flax_layout(value.detach().cpu().numpy(), parts, leaf,
                                 num_heads)
        collection = ("batch_stats" if leaf.startswith("running_")
                      else "params")
        node = tree.setdefault(collection, {})
        for part in parts:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def raft_state_from_jax(variables) -> dict:
    """A Flax ``Raft`` variables tree as the ``state_dict`` of the port's
    ``Raft`` (:func:`flax_state_from_jax`)."""
    return flax_state_from_jax(variables, "RAFT")


def superpoint_state_from_jax(variables) -> dict:
    """A Flax ``SuperPoint`` variables tree as the ``state_dict`` of the
    port's ``SuperPoint``; ``Conv_{i}`` / ``BatchNorm_{i}`` keep their
    numbers (``Conv_10`` is the descriptor head's 3x3, not the eleventh in
    the tree's sorted order)."""
    return flax_state_from_jax(variables, "SuperPoint")


def disk_state_from_jax(variables) -> dict:
    """A Flax ``Disk`` variables tree as the ``state_dict`` of the port's
    ``Disk`` (``Conv_14`` the 1x1 head)."""
    return flax_state_from_jax(variables, "DISK")


def lightglue_state_from_jax(variables) -> dict:
    """A Flax ``LightGlue`` variables tree as the ``state_dict`` of the
    port's ``LightGlue`` (``Dense`` kernels transposed)."""
    return flax_state_from_jax(variables, "LightGlue")


def cotracker_state_from_jax(variables) -> dict:
    """A Flax ``CoTracker`` variables tree as the ``state_dict`` of the
    port's ``CoTracker``: the attention's ``DenseGeneral`` kernels
    ``[D, H, Dh]`` / ``[H, Dh, D]`` as ``[H*Dh, D]`` / ``[D, H*Dh]``
    weights."""
    return flax_state_from_jax(variables, "CoTracker")


def _tensors(variables, model: str, dev) -> dict:
    """A Flax variables tree's leaves as ``state_dict`` tensors on ``dev``,
    in Flax's order, without ``num_batches_tracked``."""
    return {key: tensor.to(dev) for _, key, tensor in
            flax_leaves_from_jax(variables, model)}


def _optax_adam(opt_state):
    """(``ScaleByAdamState``, its count) of an optax chain of
    ``clip_by_global_norm`` and ``adamw``; a ``ScaleByScheduleState``'s
    count must equal Adam's, as it always does in such a chain."""
    adam, counts = [], []

    def walk(node):
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            adam.append(node)
        elif type(node).__name__ == "ScaleByScheduleState":
            counts.append(int(node.count))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(adam) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState, found "
                         f"{len(adam)}")
    count = int(adam[0].count)
    if any(c != count for c in counts):
        raise ValueError(f"the schedule's count {counts} differs from "
                         f"Adam's {count}")
    return adam[0], count


def _opt_state_from_jax(opt_state, wrap, model: str, dev) -> dict:
    adam, count = _optax_adam(opt_state)
    return {"count": torch.tensor(count, dtype=torch.int32, device=dev),
            "mu": _tensors(wrap(adam.mu), model, dev),
            "nu": _tensors(wrap(adam.nu), model, dev)}


def train_state_from_jax(state, device="cuda") -> TrainState:
    """The port's ``TrainState`` for a JAX RAFT ``TrainState``: its
    ``params`` and ``batch_stats`` in the layout of
    :func:`raft_state_from_jax`, and the optax state's Adam ``mu``, ``nu``
    and ``count`` as the ``opt_state`` of ``train/optim.py::ClipAdamW``;
    tensors on ``device``."""
    dev = torch.device(device)
    return TrainState(
        step=torch.tensor(int(state.step), dtype=torch.int32, device=dev),
        params=_tensors({"params": state.params}, "RAFT", dev),
        batch_stats=_tensors({"batch_stats": state.batch_stats}, "RAFT",
                             dev),
        opt_state=_opt_state_from_jax(state.opt_state,
                                      lambda t: {"params": t}, "RAFT", dev))


def model_train_state_from_jax(variables, opt_state, device="cuda"):
    """``(params, opt_state)`` of the port's SuperPoint, DISK or LightGlue
    trainer for a JAX trainer's ``(variables, opt_state)``: the Flax
    variables tree it optimises (SuperPoint's includes ``batch_stats``) as
    ``state_dict`` tensors in Flax's order, and optax's Adam state in the
    same layout; tensors on ``device``."""
    dev = torch.device(device)
    return (_tensors(variables, "Flax", dev),
            _opt_state_from_jax(opt_state, lambda t: t, "Flax", dev))


def cotracker_train_state_from_jax(params, ema, opt_state, device="cuda"):
    """``(params, ema, opt_state)`` of the port's CoTracker trainer
    (``train/cotracker_pretrain.py::make_train_step``) for the JAX
    trainer's: its ``params`` and parameter average (Flax ``params``
    collections, without the ``{"params": ...}`` wrapper) as
    ``state_dict`` tensors in Flax's order, and optax's Adam state in the
    same layout; tensors on ``device``."""
    dev = torch.device(device)

    def wrap(t):
        return {"params": t}

    return (_tensors(wrap(params), "CoTracker", dev),
            _tensors(wrap(ema), "CoTracker", dev),
            _opt_state_from_jax(opt_state, wrap, "CoTracker", dev))
