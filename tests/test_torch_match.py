"""CPU parity of the port's BRIEF descriptor and matchers with the JAX
package: bits, Hamming distances, match indices and statuses bit-equal,
cosine distances within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feature_tracker_tpu.core.config import HarrisOptions as JaxHarrisOptions
from feature_tracker_tpu.match import brief as jbrief
from feature_tracker_tpu.match import matcher as jmatcher
from feature_tracker_tpu.ops.detect import (
    detect_good_features as jax_detect,
)
from feature_tracker_tpu_torch.convert import options_from_jax
from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.match import brief, matcher
from feature_tracker_tpu_torch.ops.detect import detect_good_features

from synthetic import Texture, translated_pair


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("length,half,seed", [(256, 8, 7), (64, 4, 3)])
def test_brief_pattern_matches_jax(length, half, seed):
    np.testing.assert_array_equal(brief.brief_pattern(length, half, seed),
                                  jbrief.brief_pattern(length, half, seed))


def _brief_inputs(kind):
    """An image and positions: inside, on every border (rounding to just
    inside or just outside the margin), halves that round to even, and far
    off the image."""
    rng = np.random.default_rng(5)
    img = Texture(3).render(64, 80)
    if kind == "integer":       # many exact ties between smoothed values
        img = np.floor(img / 16.0)
    uv = np.concatenate([
        rng.uniform(0, 80, (60, 1)), rng.uniform(0, 64, (60, 1))], 1)
    edges = [[8.5, 30.0], [9.5, 30.0], [70.5, 30.0], [70.49, 30.0],
             [40.0, 8.5], [40.0, 9.5], [40.0, 54.5], [40.0, 54.51],
             [-500.0, 20.0], [1e6, 1e6], [12.5, 13.5], [33.5, 22.5]]
    return img, np.concatenate([uv, edges]).astype(np.float32)


@pytest.mark.parametrize("kind", ["texture", "integer"])
def test_compute_brief_bit_equal_to_jax(kind):
    img, uv = _brief_inputs(kind)
    jbits, jvalid = jbrief.compute_brief(jnp.asarray(img), jnp.asarray(uv))
    bits, valid = brief.compute_brief(img, uv)
    assert bits.dtype == torch.uint8 and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert not valid.numpy().all() and valid.numpy().any()
    assert bits.numpy()[~valid.numpy()].sum() == 0
    # Smaller patches, another pattern.
    jb2, _ = jbrief.compute_brief(jnp.asarray(img), jnp.asarray(uv),
                                  length=64, half=4, seed=3)
    b2, _ = brief.compute_brief(torch.from_numpy(img), uv, 64, 4, 3)
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2))


def test_pack_bits_matches_jax():
    bits = np.random.default_rng(0).integers(0, 2, (9, 256)).astype(np.uint8)
    bits[0] = 1                                  # the top bit of each word
    packed = brief.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.uint32 and packed.shape == (9, 8)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jbrief.pack_bits(bits)))


def test_hamming_distances_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (33, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (41, 256)).astype(np.uint8)
    d = matcher.hamming_distance_matrix(a, torch.from_numpy(b))
    assert d.dtype == torch.float32 and d.shape == (33, 41)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jmatcher.hamming_distance_matrix(a, b)))
    np.testing.assert_array_equal(d.numpy(),
                                  (a[:, None] != b[None]).sum(-1))


def test_cosine_distances_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(20, 64)).astype(np.float32)
    b = rng.normal(size=(30, 64)).astype(np.float32)
    b[3] = 0.0                                    # the eps floor
    d = matcher.cosine_distance_matrix(a, b).numpy()
    np.testing.assert_allclose(
        d, np.asarray(jmatcher.cosine_distance_matrix(a, b)), rtol=0,
        atol=1e-6)


def _match_inputs(seed):
    """Integer distances in a narrow range (many ties), positions spread
    so the gate keeps some candidates and drops others."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 12, (50, 70)).astype(np.float32)
    dist[4] = np.inf
    dist[7, 10:20] = 0.0
    pred = rng.uniform(0, 200, (50, 2)).astype(np.float32)
    cur = rng.uniform(0, 200, (70, 2)).astype(np.float32)
    return dist, pred, cur


@pytest.mark.parametrize("seed", [0, 1])
def test_force_and_nearby_match_bit_equal_to_jax(seed):
    dist, pred, cur = _match_inputs(seed)
    for thr in (0.0, 3.0, 11.5, np.inf):
        np.testing.assert_array_equal(
            matcher.force_match(dist, thr).numpy(),
            np.asarray(jmatcher.force_match(dist, thr)))
        got = matcher.nearby_match(torch.from_numpy(dist), pred, cur, thr,
                                   40, 25)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jmatcher.nearby_match(dist, pred, cur, thr, 40, 25)))


def test_forced_ties_take_the_first_index():
    """Equal minima go to the lowest index, as jnp.argmin does; a row
    accepting nothing gives -1; an exact 0 wins (the early exit)."""
    dist = np.array([[5.0, 3.0, 3.0, 3.0],
                     [9.0, 9.0, 9.0, 9.0],
                     [0.0, 2.0, 0.0, 1.0],
                     [np.inf, np.inf, np.inf, np.inf],
                     [7.0, 1.0, 7.0, 1.0]], np.float32)
    expect = [1, -1, 0, -1, 1]
    got = matcher.force_match(dist, 6.0).numpy()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got,
                                  np.asarray(jmatcher.force_match(dist, 6.0)))
    pos = np.zeros((4, 2), np.float32)
    pos[1] = [100.0, 0.0]                        # gated out
    got = matcher.nearby_match(dist, np.zeros((5, 2), np.float32), pos, 6.0,
                               40, 40).numpy()
    np.testing.assert_array_equal(got, [2, -1, 0, -1, 3])
    np.testing.assert_array_equal(got, np.asarray(jmatcher.nearby_match(
        dist, np.zeros((5, 2), np.float32), pos, 6.0, 40, 40)))


def test_fill_matched_pixels_matches_jax():
    idx = np.array([1, -1, 0, 2, -1, 1], np.int32)
    cur = np.array([[1.0, 2.0], [3.0, 4.0], [5.5, 6.5]], np.float32)
    status = np.array([0, 0, 3, 1, 4, 2], np.int8)
    for st in (None, status):
        uv, s = matcher.fill_matched_pixels(idx, cur, st)
        juv, js = jmatcher.fill_matched_pixels(idx, cur, st)
        assert s.dtype == torch.int8 and uv.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))


def _pipeline(mod_detect, mod_brief, mod_matcher, ref, cur, opts, cap):
    """bench.py's BRIEF pipeline: detect, describe, valid-masked Hamming,
    nearby match, fill."""
    ref_uv, _ = mod_detect(ref, cap, opts)
    cur_uv, _ = mod_detect(cur, cap, opts)
    ref_bits, ref_valid = mod_brief.compute_brief(ref, ref_uv)
    cur_bits, cur_valid = mod_brief.compute_brief(cur, cur_uv)
    dist = _np(mod_matcher.hamming_distance_matrix(ref_bits, cur_bits))
    dist = np.where(_np(ref_valid)[:, None] & _np(cur_valid)[None, :], dist,
                    np.inf).astype(np.float32)
    idx = mod_matcher.nearby_match(dist, ref_uv, cur_uv, 60.0, 50.0, 50.0)
    muv, st = mod_matcher.fill_matched_pixels(idx, cur_uv)
    return [_np(x) for x in (ref_uv, cur_uv, ref_bits, cur_bits, dist, idx,
                             muv, st)]


@pytest.mark.parametrize("response", [40.0, 10.0])
def test_detect_and_match_pipeline_equal_to_jax(response):
    ref, cur = translated_pair(h=240, w=320, shift=(7.0, -4.0))
    jopts = JaxHarrisOptions(min_feature_distance=20,
                             min_valid_response=response)
    got = _pipeline(lambda im, n, o: detect_good_features(im, n, o,
                                                          device="cpu"),
                    brief, matcher, ref, cur, options_from_jax(jopts), 200)
    want = _pipeline(lambda im, n, o: jax_detect(jnp.asarray(im), n, o),
                     jbrief, jmatcher, ref, cur, jopts, 200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, muv, ref_uv = got[7], got[6], got[0]
    ok = st == 1
    assert ok.sum() >= 10
    err = np.abs(muv[ok] - ref_uv[ok] - np.array([7.0, -4.0])).max(1)
    assert (err <= 1.0).mean() > 0.9


def test_matcher_options_cross_from_jax():
    theirs = jmatcher.MatcherOptions(max_valid_predict_row_distance=7,
                                     max_valid_predict_col_distance=9,
                                     max_valid_descriptor_distance=31.5)
    ours = options_from_jax(theirs)
    assert type(ours) is matcher.MatcherOptions
    assert (ours.max_valid_predict_row_distance,
            ours.max_valid_predict_col_distance,
            ours.max_valid_descriptor_distance) == (7, 9, 31.5)
    assert options_from_jax(jmatcher.MatcherOptions()) == \
        matcher.MatcherOptions()
