"""Read and write the repository's flat-pytree weight files
(``weights/*.npz``) without JAX — the counterpart of
``feature_tracker_tpu/utils/weights.py``.

A file holds the leaves ``a0 .. a{n-1}`` in JAX's flatten order and, under
``treedef``, the tree itself as text (``repr`` of the ``PyTreeDef``:
nested dict literals with ``*`` for every leaf), so the i-th ``*`` of the
text is ``a{i}``. JAX's flatten order takes a dict's entries by sorted key,
an ``OrderedDict``'s (such as a ``state_dict``) in their own order, lists
and tuples in order; ``None`` holds no leaf, and anything else is a leaf.
"""

from __future__ import annotations

import ast
import collections
import json
import os

import numpy as np
import torch

from feature_tracker_tpu_torch.convert import (
    flax_leaves_from_jax,
    flax_state_from_jax,
)

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "weights")


def weights_path(name: str) -> str:
    return os.path.join(WEIGHTS_DIR, name)


def has_weights(name: str) -> bool:
    return os.path.exists(weights_path(name))


def _children(node):
    """``(kind, keys, children)`` of a container of the tree, in JAX's
    flatten order, or None for a leaf."""
    if isinstance(node, collections.OrderedDict):
        return "ordered", list(node), list(node.values())
    if isinstance(node, dict):
        keys = sorted(node)
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, list(range(len(node))), list(node)
    if node is None:
        return "none", [], []
    return None


def _flatten(node, trail=""):
    """``(leaves, key paths, treedef text)`` of a tree, in JAX's flatten
    order; key paths as ``jax.tree_util.keystr`` writes them."""
    split = _children(node)
    if split is None:
        return [node], [trail], "*"
    kind, keys, children = split
    leaves, paths, texts = [], [], []
    for key, child in zip(keys, children):
        sub = _flatten(child, f"{trail}[{key!r}]")
        leaves += sub[0]
        paths += sub[1]
        texts.append(sub[2])
    if kind == "ordered":
        text = (f"CustomNode(OrderedDict[{tuple(keys)!r}], "
                f"[{', '.join(texts)}])")
    elif kind == "dict":
        text = "{" + ", ".join(f"{k!r}: {t}" for k, t in zip(keys, texts)) \
            + "}"
    elif kind == "list":
        text = f"[{', '.join(texts)}]"
    elif kind == "tuple":
        text = f"({', '.join(texts)}{',' if len(texts) == 1 else ''})"
    else:
        text = "None"
    return leaves, paths, text


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples, or a ``state_dict``,
    of tensors, numpy arrays or scalars) as JAX's ``save_pytree`` does: a
    compressed npz of the leaves ``a{i}`` in JAX's flatten order and the
    tree's text under ``treedef``."""
    leaves, _, text = _flatten(tree)
    np.savez_compressed(path, treedef=np.frombuffer(
        f"PyTreeDef({text})".encode(), dtype=np.uint8),
        **{f"a{i}": _as_array(x) for i, x in enumerate(leaves)})


def _rebuild(node, leaves):
    """``node``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    split = _children(node)
    if split is None:
        return next(leaves)
    kind, keys, _ = split
    if kind in ("ordered", "dict"):
        built = {k: _rebuild(node[k], leaves) for k in keys}
        return type(node)((k, built[k]) for k in node)
    if kind in ("list", "tuple"):
        return type(node)(_rebuild(child, leaves) for child in node)
    return None


def load_pytree(path: str, like):
    """Load a flattened pytree using ``like``'s structure (nested dicts,
    lists and tuples, or a ``state_dict``); its leaves become tensors, on
    the device of ``like``'s leaf where that is a tensor.

    Every loaded leaf is validated against the corresponding leaf of
    ``like`` (shape and dtype), so an architecture-mismatched or stale
    weights file fails here with a ValueError naming the leaf, as in the
    JAX package."""
    ref_leaves, paths, _ = _flatten(like)
    loaded = []
    with np.load(path) as data:
        for i, (ref_leaf, where) in enumerate(zip(ref_leaves, paths)):
            key = f"a{i}"
            if key not in data:
                raise ValueError(
                    f"{path}: missing leaf {where} (expected "
                    f"{len(ref_leaves)} leaves, file has fewer)")
            arr = data[key]
            if isinstance(ref_leaf, torch.Tensor):
                ref_shape = tuple(ref_leaf.shape)
                ref_dtype = torch.empty(0, dtype=ref_leaf.dtype).numpy().dtype
            else:
                ref_shape = tuple(np.shape(ref_leaf))
                ref_dtype = np.asarray(ref_leaf).dtype
            if tuple(arr.shape) != ref_shape or arr.dtype != ref_dtype:
                raise ValueError(
                    f"{path}: leaf {where} has shape {tuple(arr.shape)} "
                    f"dtype {arr.dtype}, model expects {ref_shape} "
                    f"{ref_dtype}")
            tensor = torch.from_numpy(arr)
            if isinstance(ref_leaf, torch.Tensor):
                tensor = tensor.to(ref_leaf.device)
            loaded.append(tensor)
    return _rebuild(like, iter(loaded))


def load_npz_tree(path: str):
    """The nested dict of numpy arrays a weight file holds."""
    with np.load(path) as data:
        text = bytes(data["treedef"]).decode()
        if not (text.startswith("PyTreeDef(") and text.endswith(")")):
            raise ValueError(f"{path}: unreadable treedef {text[:40]!r}")
        # Leaves become their index, in the order they are written.
        pieces = text[len("PyTreeDef("):-1].split("*")
        literal = "".join(f"{piece}{i}" for i, piece in
                          enumerate(pieces[:-1])) + pieces[-1]
        n_leaves = len(pieces) - 1
        n_arrays = sum(1 for name in data.files if name != "treedef")

        def fill(node, trail):
            if isinstance(node, dict):
                return {k: fill(v, trail + (k,)) for k, v in node.items()}
            if not isinstance(node, int):
                raise ValueError(f"{path}: treedef node {node!r} at "
                                 f"{'/'.join(trail)} is neither dict nor "
                                 "leaf")
            if f"a{node}" not in data:
                raise ValueError(
                    f"{path}: missing leaf {'/'.join(trail)} (a{node}; the "
                    f"tree has {n_leaves} leaves, the file {n_arrays})")
            return data[f"a{node}"]

        tree = fill(ast.literal_eval(literal), ())
        if n_arrays != n_leaves:
            raise ValueError(f"{path}: {n_arrays} arrays for a tree of "
                             f"{n_leaves} leaves")
    return tree


def _checked_state(path: str, model: str, expected) -> dict:
    """The ``state_dict`` a weight file holds, every leaf held against the
    model's own ``expected`` state: a missing leaf, an extra leaf or a
    wrong shape raises a ValueError naming the leaf."""
    tree = load_npz_tree(path)
    leaf_of = {key: where for where, key, _ in
               flax_leaves_from_jax(tree, model)}
    state = flax_state_from_jax(tree, model)
    for key, tensor in state.items():
        where = leaf_of.get(key, key)
        if key not in expected:
            raise ValueError(f"{path}: leaf {where} has no place in the "
                             f"{model} model (no {key})")
        if tensor.shape != expected[key].shape:
            raise ValueError(
                f"{path}: leaf {where} has shape {tuple(tensor.shape)}, "
                f"the model expects {tuple(expected[key].shape)} for {key}")
    for key in expected:
        if key not in state:
            raise ValueError(f"{path}: no leaf for the {model} model's {key}")
    return state


def load_raft_npz(path: str, cfg) -> dict:
    """``state_dict`` of ``Raft(cfg)`` from a RAFT weight file
    (``weights/raft.npz`` for the full configuration, ``raft_small.npz`` for
    the compact one). Every leaf is held against the model's own shapes:
    a file of another architecture fails here, naming the leaf."""
    from feature_tracker_tpu_torch.models.raft import Raft

    return _checked_state(path, "RAFT",
                          Raft(cfg, device="cpu").state_dict())


def load_superpoint_npz(path: str, cfg=None) -> dict:
    """``state_dict`` of ``SuperPoint(cfg)`` (default config) from
    ``weights/superpoint.npz``, each leaf checked as in
    :func:`load_raft_npz`."""
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )

    model = SuperPoint(cfg or SuperPointConfig(), device="cpu")
    return _checked_state(path, "SuperPoint", model.state_dict())


def load_disk_npz(path: str, cfg=None) -> dict:
    """``state_dict`` of ``Disk(cfg)`` (default config) from
    ``weights/disk.npz``, each leaf checked."""
    from feature_tracker_tpu_torch.models.disk import Disk, DiskConfig

    return _checked_state(path, "DISK",
                          Disk(cfg or DiskConfig(), device="cpu").state_dict())


def load_lightglue_npz(path: str, cfg=None) -> dict:
    """``state_dict`` of ``LightGlue(cfg)`` (default: the SuperPoint
    variant, 256-d descriptors, depth 9) from
    ``weights/lightglue_superpoint.npz`` or, with
    ``LightGlueConfig(descriptor_dim=128)``, ``lightglue_disk.npz``; each
    leaf checked."""
    from feature_tracker_tpu_torch.models.lightglue import (
        LightGlue,
        LightGlueConfig,
    )

    model = LightGlue(cfg or LightGlueConfig(), device="cpu")
    return _checked_state(path, "LightGlue", model.state_dict())


def shipped_cotracker_config():
    """The ``CoTrackerConfig`` that ``weights/cotracker.npz`` was trained
    at, from ``weights/metrics.json["cotracker"]["config"]``."""
    from feature_tracker_tpu_torch.models.cotracker import CoTrackerConfig

    with open(weights_path("metrics.json")) as fh:
        return CoTrackerConfig(**json.load(fh)["cotracker"]["config"])


def load_cotracker_npz(path: str, cfg=None) -> dict:
    """``state_dict`` of ``CoTracker(cfg)`` (default: the shipped config,
    :func:`shipped_cotracker_config`) from ``weights/cotracker.npz``; each
    leaf checked."""
    from feature_tracker_tpu_torch.models.cotracker import CoTracker

    model = CoTracker(cfg or shipped_cotracker_config(), device="cpu")
    return _checked_state(path, "CoTracker", model.state_dict())
