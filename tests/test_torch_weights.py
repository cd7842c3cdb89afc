"""The port's npz pytree files against the JAX package's: files written by
either side are read by the other with equal leaves, in JAX's flatten
order, and a file that does not fit the tree it is read into fails naming
the leaf. Round trips are exact."""

import collections

import jax
import numpy as np
import pytest
import torch

from feature_tracker_tpu.utils import weights as jax_weights
from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.utils import weights


def _tree(seed):
    """Nested dicts (keys out of order), a list, a tuple, None, a scalar and
    arrays of several dtypes, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": [rng.normal(size=(3, 2)).astype(np.float32),
                 (rng.integers(0, 9, 4).astype(np.int32), None)],
        "alpha": {"b": rng.uniform(size=5) > 0.5,
                  "a": rng.normal(size=(2, 1, 3)),
                  "c": np.float32(1.5)},
        "mid": (rng.integers(0, 9, (2, 2)).astype(np.int64),),
    }


def _state_dict():
    """A real state_dict (an OrderedDict: JAX keeps its order)."""
    torch.manual_seed(0)
    return raft.FeatureEncoder(1, 8).state_dict()


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("kind", ["nested", "state_dict"])
def test_port_file_is_read_by_jax(tmp_path, kind):
    tree = _tree(0) if kind == "nested" else _state_dict()
    path = str(tmp_path / "tree.npz")
    weights.save_pytree(path, tree)
    like = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tree))
    got = jax_weights.load_pytree(path, like)
    want_leaves = jax.tree_util.tree_leaves(tree)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) > 3
    for a, b in zip(want_leaves, got_leaves):
        # JAX holds 64-bit leaves as 32-bit ones (x64 off): as jnp.asarray.
        np.testing.assert_array_equal(np.asarray(b),
                                      np.asarray(jax.numpy.asarray(a)))
    # The treedef text is JAX's own.
    with np.load(path) as data:
        text = bytes(data["treedef"]).decode()
    assert text == repr(jax.tree_util.tree_structure(like))


@pytest.mark.parametrize("kind", ["nested", "state_dict"])
def test_jax_file_is_read_by_the_port(tmp_path, kind):
    tree = _tree(1) if kind == "nested" else {
        k: v.numpy() for k, v in _state_dict().items()}
    path = str(tmp_path / "tree.npz")
    jax_weights.save_pytree(path, tree)
    if kind == "nested":
        like = jax.tree_util.tree_map(
            lambda x: torch.zeros(np.shape(x), dtype=torch.from_numpy(
                np.asarray(x)).dtype), tree)
    else:
        # A state_dict keeps the module's order; the file holds JAX's
        # sorted one: the port reads it into a plain dict of the same keys.
        like = dict(_state_dict())
    got = weights.load_pytree(path, like)
    assert type(got) is type(like) and list(got) == list(like)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(), got))):
        np.testing.assert_array_equal(b, np.asarray(a))
    if kind == "nested":
        _equal(tree["zeta"][1][0], got["zeta"][1][0])
        assert got["zeta"][1][1] is None and isinstance(got["mid"], tuple)
        _equal(tree["alpha"]["c"], got["alpha"]["c"])
    # And back: the port's file of what it read is the JAX file's twin.
    again = str(tmp_path / "again.npz")
    weights.save_pytree(again, got)
    with np.load(path) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("fault", ["shape", "dtype", "missing"])
def test_a_file_that_does_not_fit_raises_naming_the_leaf(tmp_path, fault):
    tree = _tree(2)
    path = str(tmp_path / "tree.npz")
    weights.save_pytree(path, tree)
    like = jax.tree_util.tree_map(np.zeros_like, tree)
    if fault == "shape":
        like["alpha"]["a"] = np.zeros((2, 3))
        match = r"\['alpha'\]\['a'\] has shape \(2, 1, 3\)"
    elif fault == "dtype":
        like["mid"] = (np.zeros((2, 2), np.int32),)
        match = r"\['mid'\]\[0\] has shape \(2, 2\) dtype int64"
    else:
        like["zeta"].append(np.zeros(3, np.float32))
        match = r"missing leaf \['zeta'\]\[2\]"
    with pytest.raises(ValueError, match=match):
        jax_weights.load_pytree(path, like)
    with pytest.raises(ValueError, match=match):
        weights.load_pytree(path, like)
    with pytest.raises(ValueError, match=match):
        weights.load_pytree(path, jax.tree_util.tree_map(torch.from_numpy,
                                                         like))
