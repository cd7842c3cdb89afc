"""The port's learned-matching demos (``match_superpoint_demo``,
``match_disk_demo``, ``nn_matcher_demo``) against the JAX demos, on the
CPU, on the shipped weights and the synthetic 752x480 pair.

The reference side replays the JAX demo's calls with the JAX package, its
module constants read from the demo file by AST (tests/test_torch_demos.py
says why no JAX demo module is imported). Tolerances are those of
tests/test_torch_superpoint.py and tests/test_torch_lightglue.py: the same
keypoints and counts, and the same matches: matched uv and statuses equal;
the overlays bit-equal to JAX's renderer on the JAX results.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.utils.viz import render_matches
from test_torch_demos import (
    assert_writes_only,
    jax_constants,
    synthetic_inputs,
)

TRACKED, NOT_TRACKED = 1, 0


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while a module of these runs: the
    suite runs several test files at once on the CPU, and more threads per
    file only wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pair():
    return synthetic_inputs()[0]


def assert_same_matches(got, n_ref, n_cur, ref_uv, matched_uv, status):
    assert (got["n_ref"], got["n_cur"]) == (int(n_ref), int(n_cur))
    np.testing.assert_array_equal(got["ref_uv"], np.asarray(ref_uv))
    np.testing.assert_array_equal(got["status"], np.asarray(status))
    np.testing.assert_array_equal(got["matched_uv"], np.asarray(matched_uv))
    assert got["tracked"] == int((np.asarray(status) == TRACKED).sum())


def jax_cosine_match(detector, ref, cur):
    """The JAX descriptor-matching demos' body."""
    from feature_tracker_tpu.match.matcher import (
        cosine_distance_matrix,
        fill_matched_pixels,
        nearby_match,
    )

    ref_uv, ref_desc, n_ref = detector.detect(jnp.asarray(ref))
    cur_uv, cur_desc, n_cur = detector.detect(jnp.asarray(cur))
    n_ref, n_cur = int(n_ref), int(n_cur)
    dist = cosine_distance_matrix(ref_desc[:n_ref], cur_desc[:n_cur])
    idx = nearby_match(dist, ref_uv[:n_ref], cur_uv[:n_cur],
                       max_valid_distance=0.1,
                       max_col_distance=50.0, max_row_distance=50.0)
    matched_uv, status = fill_matched_pixels(idx, cur_uv[:n_cur])
    return (n_ref, n_cur, np.asarray(ref_uv[:n_ref]), np.asarray(matched_uv),
            np.asarray(status))


@pytest.mark.parametrize("demo", ["match_superpoint_demo",
                                  "match_disk_demo"])
def test_descriptor_matching_demo_matches_jax(demo, pair, tmp_path):
    import importlib

    from feature_tracker_tpu.models.disk import DiskDetector
    from feature_tracker_tpu.models.superpoint import SuperPointDetector

    ref, cur, source = pair
    module = importlib.import_module(f"feature_tracker_tpu_torch.demos.{demo}")
    got = module.run(ref, cur, source, device="cpu", out_dir=str(tmp_path))
    cap = jax_constants(demo)["MAX_FEATURES"]
    if demo == "match_superpoint_demo":
        detector = SuperPointDetector.from_file(max_features=cap,
                                                min_response=0.01)
        png = "match_superpoint.png"
    else:
        detector = DiskDetector.from_file(max_features=cap)
        png = "match_disk.png"
    assert detector is not None and got["kind"] == "pretrained weights"
    want = jax_cosine_match(detector, ref, cur)
    assert_same_matches(got, *want)
    assert got["tracked"] > 50
    np.testing.assert_array_equal(got["png"][png],
                                  render_matches(ref, cur, *want[2:]))
    assert_writes_only(tmp_path, got, [png])


def test_nn_matcher_demo_matches_jax(pair, tmp_path):
    from feature_tracker_tpu.match.nn_matcher import (
        NNFeatureMatcher,
        NNMatcherModelType,
        NNMatcherOptions,
    )
    from feature_tracker_tpu.models.disk import DiskDetector
    from feature_tracker_tpu.models.superpoint import SuperPointDetector
    from feature_tracker_tpu_torch.demos import nn_matcher_demo

    ref, cur, source = pair
    got = nn_matcher_demo.run(ref, cur, source, device="cpu",
                              out_dir=str(tmp_path))
    assert got["kind"] == "pretrained weights"
    cap = jax_constants("nn_matcher_demo")["MAX_FEATURES"]
    lanes = jnp.arange(cap)

    def replay(detector, model_type):
        matcher = NNFeatureMatcher.from_file(NNMatcherOptions(
            max_number_of_matches=cap,
            min_valid_match_score=math.log(0.03),
            model_type=model_type, depth=9))
        assert matcher is not None
        ruv, rd, nr = detector.detect(jnp.asarray(ref))
        cuv, cd, nc = detector.detect(jnp.asarray(cur))
        muv, st = matcher.match(rd, cd, ruv, cuv, lanes < nr, lanes < nc)
        st = np.array(st)
        st[~np.asarray(lanes < nr)] = NOT_TRACKED
        return int(nr), int(nc), np.asarray(ruv), np.asarray(muv), st

    sp = SuperPointDetector.from_file(max_features=cap, min_response=0.01)
    disk = DiskDetector.from_file(max_features=cap)
    for key, detector, model_type, png in [
            ("superpoint", sp,
             NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT,
             "nn_matcher_lightglue.png"),
            ("disk", disk, NNMatcherModelType.LIGHTGLUE_DISK_SCORE_MAT,
             "nn_matcher_lightglue_disk.png")]:
        want = replay(detector, model_type)
        assert_same_matches(got[key], *want)
        assert got[key]["tracked"] > 50
        np.testing.assert_array_equal(got["png"][png],
                                      render_matches(ref, cur, *want[2:]))
    assert_writes_only(tmp_path, got, ["nn_matcher_lightglue.png",
                                       "nn_matcher_lightglue_disk.png"])
