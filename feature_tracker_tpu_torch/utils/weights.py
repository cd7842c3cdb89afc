"""Read the repository's flat-pytree weight files (``weights/*.npz``)
without JAX — the counterpart of ``feature_tracker_tpu/utils/weights.py``.

A file holds the leaves ``a0 .. a{n-1}`` in flatten order and, under
``treedef``, the tree itself as text (``repr`` of the ``PyTreeDef``:
nested dict literals with ``*`` for every leaf), so the i-th ``*`` of the
text is ``a{i}``.
"""

from __future__ import annotations

import ast
import os

import numpy as np

from feature_tracker_tpu_torch.convert import (
    raft_leaves_from_jax,
    raft_state_from_jax,
)

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "weights")


def weights_path(name: str) -> str:
    return os.path.join(WEIGHTS_DIR, name)


def has_weights(name: str) -> bool:
    return os.path.exists(weights_path(name))


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


def load_raft_npz(path: str, cfg) -> dict:
    """``state_dict`` of ``Raft(cfg)`` from a RAFT weight file
    (``weights/raft.npz`` for the full configuration, ``raft_small.npz`` for
    the compact one). Every leaf is held against the model's own shapes:
    a file of another architecture fails here, naming the leaf."""
    from feature_tracker_tpu_torch.models.raft import Raft

    tree = load_npz_tree(path)
    leaf_of = {key: where for where, key, _ in raft_leaves_from_jax(tree)}
    state = raft_state_from_jax(tree)
    expected = Raft(cfg, device="cpu").state_dict()
    for key, tensor in state.items():
        where = leaf_of.get(key, key)
        if key not in expected:
            raise ValueError(f"{path}: leaf {where} has no place in the "
                             f"model (no {key})")
        if tensor.shape != expected[key].shape:
            raise ValueError(
                f"{path}: leaf {where} has shape {tuple(tensor.shape)}, "
                f"the model expects {tuple(expected[key].shape)} for {key}")
    for key in expected:
        if key not in state:
            raise ValueError(f"{path}: no leaf for the model's {key}")
    return state
