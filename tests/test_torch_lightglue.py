"""CPU parity of the port's LightGlue and NNFeatureMatcher with the JAX
package.

The same numpy inputs go through the Flax model and the port on the CPU.
Seeded weights are initialised by Flax under ``jax.jit`` (a small model:
width 32, 2 heads, depth 2), every bias and LayerNorm scale perturbed with
numpy, and carried over by ``lightglue_state_from_jax``; the shipped
``weights/lightglue_superpoint.npz`` and ``lightglue_disk.npz`` go to both
sides through their own loaders.

Tolerances, and what was observed on the CPU when they were set:
  - log-assignment scores of valid pairs: 1e-3 (observed 1.3e-4 / 2.0e-4
    with the shipped SuperPoint / DISK weights: nine layers of products
    summed in another order); masked entries exactly NEG_INF;
  - matchability logits: 1e-4 (observed <= 2.9e-5);
  - mutual argmax, the fused match list and the matcher's matched
    positions and statuses: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.match import nn_matcher as jnn
from feature_tracker_tpu.models import lightglue as jlg
from feature_tracker_tpu.utils import weights as jax_weights
from feature_tracker_tpu_torch.convert import (
    lightglue_state_from_jax,
    options_from_jax,
)
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.match import nn_matcher
from feature_tracker_tpu_torch.models import lightglue as lg
from feature_tracker_tpu_torch.utils.weights import (
    load_lightglue_npz,
    weights_path,
)

SMALL = jlg.LightGlueConfig(descriptor_dim=32, model_dim=32, num_heads=2,
                            depth=2)


def _perturbed(variables, seed):
    """Flax variables as numpy, every bias and LayerNorm scale made
    non-trivial (Flax initialises them to 0 and 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _inputs(n, m, d, seed, masked0=0, masked1=0, spread=640.0):
    """Keypoints, L2-normalised descriptors and masks (the last
    ``masked0`` / first ``masked1`` points masked out)."""
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, spread, (n, 2)).astype(np.float32)
    k1 = rng.uniform(0, spread, (m, 2)).astype(np.float32)
    d0 = rng.normal(0, 1, (n, d)).astype(np.float32)
    d1 = rng.normal(0, 1, (m, d)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    m0 = np.arange(n) < n - masked0
    m1 = np.arange(m) >= masked1
    return k0, d0, m0, k1, d1, m1


def _assert_scores_match(got, want, m0, m1):
    scores, l0, l1 = (t.numpy() for t in got)
    ws, w0, w1 = (np.asarray(a) for a in want)
    pair = m0[:, None] & m1[None, :]
    assert scores.shape == ws.shape
    assert np.abs(scores - ws)[pair].max(initial=0.0) <= 1e-3
    assert (scores[~pair] == lg.NEG_INF).all()
    assert (ws[~pair] == scores[~pair]).all()
    np.testing.assert_allclose(l0, w0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(l1, w1, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def seeded():
    model = jlg.LightGlue(SMALL)
    args = _inputs(13, 10, SMALL.descriptor_dim, 0)
    variables = _perturbed(jax.jit(model.init)(jax.random.PRNGKey(0),
                                               *args), 3)
    port = lg.LightGlue(options_from_jax(SMALL), device="cpu")
    port.load_state_dict(lightglue_state_from_jax(variables))
    return model, variables, port


@pytest.mark.parametrize("case", ["all valid", "masked", "image_hw",
                                  "one side masked out"])
def test_lightglue_matches_jax_on_seeded_weights(seeded, case):
    model, variables, port = seeded
    masked0, masked1 = {"all valid": (0, 0), "masked": (3, 2),
                        "image_hw": (3, 2),
                        "one side masked out": (0, 10)}[case]
    args = _inputs(13, 10, SMALL.descriptor_dim, 1, masked0, masked1)
    hw = (480, 640) if case == "image_hw" else None
    want = jax.jit(lambda *a: model.apply(variables, *a, image_hw=hw))(*args)
    _assert_scores_match(port(*args, image_hw=hw), want, args[2], args[5])


def test_normalize_keypoints_and_rotary_match_jax():
    k0, _, m0, _, _, _ = _inputs(9, 4, 4, 2, masked0=3)
    for mask in (m0, np.zeros(9, bool)):
        for hw in (None, (61, 90)):
            want = jlg.normalize_keypoints(jnp.asarray(k0), jnp.asarray(mask),
                                           hw)
            got = lg.normalize_keypoints(torch.from_numpy(k0),
                                         torch.from_numpy(mask), hw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (5, 2, 8)).astype(np.float32)
    ang = rng.uniform(-3, 3, (5, 4)).astype(np.float32)
    want = jlg.apply_rotary(jnp.asarray(x), jnp.cos(ang), jnp.sin(ang))
    got = lg.apply_rotary(torch.from_numpy(x), torch.cos(torch.from_numpy(
        ang)), torch.sin(torch.from_numpy(ang)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


VARIANTS = {256: "lightglue_superpoint.npz", 128: "lightglue_disk.npz"}


@pytest.fixture(scope="module")
def shipped():
    """Each shipped variant on both sides, and the JAX side's outputs on
    N = 64 keypoints (8 masked on each side), with and without
    ``image_hw``, computed once."""
    out = {}
    for dim, name in VARIANTS.items():
        jcfg = jlg.LightGlueConfig(descriptor_dim=dim)
        jmodel = jlg.LightGlue(jcfg)
        args = _inputs(64, 64, dim, 4, masked0=8, masked1=8, spread=480.0)
        like = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args))
        variables = jax_weights.load_pytree(weights_path(name), like)
        port = lg.LightGlue(options_from_jax(jcfg), device="cpu")
        port.load_state_dict(load_lightglue_npz(weights_path(name),
                                                port.cfg))
        want = {hw: jax.jit(lambda *a, hw=hw: jmodel.apply(
            variables, *a, image_hw=hw))(*args)
            for hw in (None, (480, 752))}
        out[dim] = (port, args, want, variables)
    return out


@pytest.mark.parametrize("hw", [None, (480, 752)])
@pytest.mark.parametrize("dim", [256, 128])
def test_shipped_lightglue_matches_jax(shipped, dim, hw):
    port, args, want, _ = shipped[dim]
    _assert_scores_match(port(*args, image_hw=hw), want[hw], args[2],
                         args[5])


def _planted_scores(seed):
    """A score matrix with planted ties (equal row maxima, equal column
    maxima, equal match scores), -inf and NEG_INF rows and columns, and
    scores on both sides of the threshold."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.uniform(-6, 0, (12, 9)), 1).astype(np.float32)
    s[1, 3] = s[1, 5] = 0.5          # a row with two equal maxima
    s[4, 7] = s[6, 7] = 0.7          # a column with two equal maxima
    s[8, 0] = s[9, 1] = 0.9          # two matches of equal score
    s[2, :] = -np.inf
    s[10, :] = lg.NEG_INF
    s[:, 8] = -np.inf
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_matches", [300, 3])
def test_mutual_argmax_and_fused_list_match_jax(seed, max_matches):
    s = _planted_scores(seed)
    want_idx = jlg.mutual_argmax_matches(jnp.asarray(s), -3.0)
    idx = lg.mutual_argmax_matches(torch.from_numpy(s), -3.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert idx.dtype == torch.int32
    want_pairs, want_sc = jlg.fused_match_list(jnp.asarray(s), -3.0,
                                               max_matches)
    pairs, sc = lg.fused_match_list(torch.from_numpy(s), -3.0, max_matches)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want_pairs))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want_sc))
    assert pairs.dtype == torch.int32


@pytest.mark.parametrize("variant", list(nn_matcher.NNMatcherModelType))
def test_nn_matcher_matches_jax(shipped, variant):
    dim = 256 if "SUPERPOINT" in variant.name else 128
    _, args, _, variables = shipped[dim]
    k0, d0, m0, _, _, m1 = args
    # The current image: the reference points moved by (7, -4) with their
    # descriptors a little disturbed, so that most points match. The DISK
    # variants see 14 points fewer there, and unmatched points then get
    # zeros instead of their current position.
    m = 64 if dim == 256 else 50
    rng = np.random.default_rng(5)
    k1 = (k0 + np.array([7.0, -4.0], np.float32))[:m]
    d1 = d0[:m] + rng.normal(0, 0.05, (m, dim)).astype(np.float32)
    m1 = m1[:m]
    jopts = jnn.NNMatcherOptions(
        model_type=jnn.NNMatcherModelType(variant.value))
    jm = jnn.NNFeatureMatcher(jopts, variables=variables)
    want_uv, want_st = jm.match(d0, d1, k0, k1, m0, m1)
    pm = nn_matcher.NNFeatureMatcher.from_file(options_from_jax(jopts),
                                               device="cpu")
    uv, st = pm.match(d0, d1, k0, k1, m0, m1)
    assert st.dtype == torch.int8
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(want_uv))
    tracked = int((st == int(TrackStatus.TRACKED)).sum())
    assert tracked > 20
    if m < 64:
        assert (uv.numpy()[st.numpy() != 1] == 0).all()


def test_nn_matcher_entry_points(tmp_path):
    opts = nn_matcher.NNMatcherOptions(max_number_of_matches=16, depth=2)
    assert nn_matcher.NNFeatureMatcher.from_file(opts, device="cpu") is None
    assert nn_matcher.NNFeatureMatcher.from_file(
        nn_matcher.NNMatcherOptions(), path=str(tmp_path / "absent.npz"),
        device="cpu") is None
    a = nn_matcher.NNFeatureMatcher(opts, rng=3, device="cpu")
    assert a.variables is None
    assert a.initialize() and a.variables is not None
    b = nn_matcher.NNFeatureMatcher(opts, rng=3, device="cpu")
    k0, d0, m0, k1, d1, m1 = _inputs(7, 5, 256, 6)
    # The first call initialises with the same seed: equal scores.
    assert torch.equal(a.scores(k0, d0, k1, d1), b.scores(k0, d0, k1, d1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nn_matcher.NNFeatureMatcher.from_file()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lg.LightGlue()
