"""The port's npz pytree files against the JAX package's: files written by
either side are read by the other with equal leaves, in JAX's flatten
order, and a file that does not fit the tree it is read into fails naming
the leaf. Round trips are exact. The five shipped neural-model files load
into the port's models without JAX, each model's ``*_state_from_jax`` gives
from the JAX package's reading of a file what the port's loader gives, and
a file of another architecture fails naming the leaf."""

import collections
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from feature_tracker_tpu.utils import weights as jax_weights
from feature_tracker_tpu_torch import convert
from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.models.lightglue import LightGlueConfig
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


# The shipped neural-model files: (file, port loader, its config, the
# converter, the Flax model and example inputs for its variables' shapes).
def _model_files():
    from feature_tracker_tpu.models import cotracker as jct
    from feature_tracker_tpu.models import disk as jdisk
    from feature_tracker_tpu.models import lightglue as jlg
    from feature_tracker_tpu.models import superpoint as jsp

    img = np.zeros((1, 32, 32, 1), np.float32)

    def glue(dim):
        k = np.zeros((4, 2), np.float32)
        d = np.zeros((4, dim), np.float32)
        m = np.ones(4, bool)
        return (jlg.LightGlue(jlg.LightGlueConfig(descriptor_dim=dim)),
                (k, d, m, k, d, m))

    with open(weights.weights_path("metrics.json")) as fh:
        cot = jct.CoTracker(jct.CoTrackerConfig(
            **json.load(fh)["cotracker"]["config"]))
    return {
        "superpoint.npz": (weights.load_superpoint_npz, None,
                           convert.superpoint_state_from_jax,
                           jsp.SuperPoint(), (img,)),
        "disk.npz": (weights.load_disk_npz, None,
                     convert.disk_state_from_jax, jdisk.Disk(), (img,)),
        "lightglue_superpoint.npz": (weights.load_lightglue_npz, None,
                                     convert.lightglue_state_from_jax,
                                     *glue(256)),
        "lightglue_disk.npz": (weights.load_lightglue_npz,
                               LightGlueConfig(descriptor_dim=128),
                               convert.lightglue_state_from_jax,
                               *glue(128)),
        "cotracker.npz": (weights.load_cotracker_npz, None,
                          convert.cotracker_state_from_jax, cot,
                          (np.zeros((2, 32, 32, 1), np.float32),
                           np.zeros((3, 2), np.float32))),
    }


def test_shipped_model_files_load_without_jax():
    code = (
        "import sys\n"
        "from feature_tracker_tpu_torch.utils import weights as w\n"
        "from feature_tracker_tpu_torch.models import cotracker, disk, "
        "lightglue, superpoint\n"
        "pairs = [(superpoint.SuperPoint(device='cpu'), "
        "w.load_superpoint_npz(w.weights_path('superpoint.npz'))),\n"
        "  (disk.Disk(device='cpu'), "
        "w.load_disk_npz(w.weights_path('disk.npz'))),\n"
        "  (lightglue.LightGlue(device='cpu'), w.load_lightglue_npz("
        "w.weights_path('lightglue_superpoint.npz'))),\n"
        "  (lightglue.LightGlue(lightglue.LightGlueConfig(descriptor_dim="
        "128), device='cpu'), w.load_lightglue_npz(w.weights_path("
        "'lightglue_disk.npz'), lightglue.LightGlueConfig("
        "descriptor_dim=128))),\n"
        "  (cotracker.CoTracker(w.shipped_cotracker_config(), "
        "device='cpu'), w.load_cotracker_npz(w.weights_path("
        "'cotracker.npz')))]\n"
        "counts = []\n"
        "for model, state in pairs:\n"
        "    model.load_state_dict(state)\n"
        "    counts.append(sum(p.numel() for p in model.parameters()))\n"
        "assert counts == [1303425, 1950529, 11386945, 11354177, "
        "2871267], counts\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'feature_tracker_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


@pytest.mark.parametrize("name", ["superpoint.npz", "disk.npz",
                                  "lightglue_superpoint.npz",
                                  "lightglue_disk.npz", "cotracker.npz"])
def test_converters_give_what_the_loaders_give(name):
    """The JAX package's own reading of a file, carried over by the
    model's ``*_state_from_jax``, is the port loader's state_dict."""
    load, cfg, to_state, model, example = _model_files()[name]
    path = weights.weights_path(name)
    like = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0), *example))
    variables = jax.device_get(jax_weights.load_pytree(path, like))
    want = to_state(variables)
    got = load(path, cfg)
    assert list(got) == list(want) and len(got) > 20
    for key in got:
        assert torch.equal(got[key], want[key]), key


def _rewritten(tmp_path, name, edit):
    """A copy of a shipped file with its tree changed by ``edit``."""
    tree = weights.load_npz_tree(weights.weights_path(name))
    edit(tree)
    path = str(tmp_path / name)
    weights.save_pytree(path, tree)
    return path


@pytest.mark.parametrize("fault", ["other variant", "dropped leaf",
                                   "transposed kernel", "extra leaf"])
def test_a_model_file_that_does_not_fit_raises_naming_the_leaf(tmp_path,
                                                               fault):
    if fault == "other variant":
        with pytest.raises(ValueError, match=r"leaf params/input_proj/"
                           r"kernel has shape \(256, 128\)"):
            weights.load_lightglue_npz(
                weights.weights_path("lightglue_disk.npz"))
        return
    if fault == "dropped leaf":
        path = _rewritten(tmp_path, "superpoint.npz", lambda t: t[
            "params"]["Conv_10"].pop("bias"))
        with pytest.raises(ValueError, match=r"no leaf for the SuperPoint "
                           r"model's Conv_10\.bias"):
            weights.load_superpoint_npz(path)
        return
    if fault == "transposed kernel":
        def edit(tree):
            proj = tree["params"]["token_proj"]
            proj["kernel"] = np.ascontiguousarray(proj["kernel"].T)
        path = _rewritten(tmp_path, "cotracker.npz", edit)
        with pytest.raises(ValueError, match=r"leaf params/token_proj/"
                           r"kernel has shape \(290, 192\)"):
            weights.load_cotracker_npz(path)
        return
    path = _rewritten(tmp_path, "disk.npz", lambda t: t["params"].update(
        Conv_15={"bias": np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match=r"leaf params/Conv_15/bias has no "
                       r"place in the DISK model"):
        weights.load_disk_npz(path)
