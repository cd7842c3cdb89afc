"""CPU parity of the port's Farnebäck dense flow with the JAX package.

The flow is chaotic at the last bit: JAX's bfloat16 gather table turns a
one-ulp difference into a flipped rounding, and its CPU convolution sums
the moment taps with fused multiply-adds, which the port's float32 passes
do not. So whole flows are held to JAX by statistics over interior pixels
(mean |d| <= 1e-3 px, 99th percentile <= 5e-3 px); the deterministic parts
(kernel moments, bfloat16 rounding, median, upsampling) bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.trackers import dense as jdense
from feature_tracker_tpu_torch.convert import options_from_jax, tracker_from_jax
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.runtime import cpu_baseline
from feature_tracker_tpu_torch.trackers import dense

from synthetic import translated_pair

MEAN_TOL, P99_TOL = 1e-3, 5e-3       # px, interior pixels
MARGIN = 20


def _interior(a, m=MARGIN):
    return np.asarray(a)[..., m:-m, m:-m]


def _assert_close_in_distribution(got, want):
    d = np.abs(_interior(got) - _interior(want))
    assert d.mean() <= MEAN_TOL, d.mean()
    assert np.percentile(d, 99) <= P99_TOL, np.percentile(d, 99)


@pytest.mark.parametrize("half", [0, 1, 2, 3])
def test_kernel_moments_equal_jax(half):
    g1, k2, k4, k22 = dense._kernel_moments(half)
    jg1, jk2, jk4, jk22 = jdense._kernel_moments(half)
    np.testing.assert_array_equal(g1, jg1)
    assert (k2, k4, k22) == (jk2, jk4, jk22)


@pytest.mark.parametrize("half", [1, 2, 3])
def test_moments_match_jax(half):
    """Within 1e-4 of each moment map's largest magnitude."""
    img, _ = translated_pair(h=61, w=77)
    g1 = dense._kernel_moments(half)[0]
    got = dense._moments(torch.from_numpy(img), half, g1).numpy()
    want = np.asarray(jdense._moments(jnp.asarray(img), half, g1))
    assert got.shape == want.shape == (6, 61, 77)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * scale).all()


def test_bfloat16_rounding_equals_jax():
    """Round to nearest even, as XLA's convert: ties included."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 300).astype(np.float32)
    # Exact ties between two bfloat16 values: the dropped 16 bits 0x8000.
    ties = (np.arange(512, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([x, ties[np.isfinite(ties)]])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(
        dense._bf16_round(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape", [(13, 17), (8, 8), (1, 5)])
def test_median3x3_bit_equal_to_jax(shape):
    flow = np.random.default_rng(1).normal(size=(2,) + shape).astype(
        np.float32)
    flow[0, 0, :2] = 0.25                        # repeated values
    np.testing.assert_array_equal(
        dense._median3x3(torch.from_numpy(flow)).numpy(),
        np.asarray(jdense._median3x3(jnp.asarray(flow))))


@pytest.mark.parametrize("src,out", [((7, 9), (14, 18)), ((7, 9), (15, 19)),
                                     ((6, 5), (13, 10)), ((1, 1), (3, 3))])
def test_upsample_flow_bit_equal_to_jax(src, out):
    flow = np.random.default_rng(2).normal(size=(2,) + src).astype(np.float32)
    got = dense._upsample_flow(torch.from_numpy(flow), out)
    assert tuple(got.shape) == (2,) + out
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdense._upsample_flow(jnp.asarray(flow), out)))


@pytest.fixture(scope="module")
def pair():
    return translated_pair(h=120, w=160, shift=(3.0, -2.0))


def test_track_single_level_matches_jax(pair):
    ref, cur = translated_pair(h=120, w=160, shift=(1.3, -0.8), seed=2)
    opts = jdense.DenseFlowOptions(max_iterations=10)
    init = np.full((2, 120, 160), 0.25, np.float32)
    for start in (None, init):
        want = jdense.DenseOpticalFlow(opts).track_single_level(ref, cur,
                                                                start)
        tracker = dense.DenseOpticalFlow(options_from_jax(opts),
                                         device="cpu")
        got = tracker.track_single_level(ref, cur, start)
        assert got.dtype == torch.float32 and got.shape == (2, 120, 160)
        _assert_close_in_distribution(got.numpy(), want)
        assert len(tracker.last_stats["iterations"]) == 1


def test_track_matches_jax(pair):
    ref, cur = pair
    opts = jdense.DenseFlowOptions(half_patch_size=2, max_iterations=20)
    want = jdense.DenseOpticalFlow(opts).track(
        jax_pyramid(jnp.asarray(ref), 3, quantize=False),
        jax_pyramid(jnp.asarray(cur), 3, quantize=False))
    tracker = tracker_from_jax(jdense.DenseOpticalFlow(opts), device="cpu")
    got = tracker.track(build_pyramid(ref, 3, quantize=False, device="cpu"),
                        build_pyramid(cur, 3, quantize=False, device="cpu"))
    _assert_close_in_distribution(got.numpy(), want)
    its = tracker.last_stats["iterations"]
    assert len(its) == 3 and tracker.last_stats["host_syncs"] == sum(its)
    flow = _interior(got.numpy())
    np.testing.assert_allclose(np.median(flow[0]), -2.0, atol=0.05)
    np.testing.assert_allclose(np.median(flow[1]), 3.0, atol=0.05)


def test_identical_images_give_exactly_zero_flow():
    ref, _ = translated_pair(h=96, w=96, seed=5)
    tracker = dense.DenseOpticalFlow(device="cpu")
    flow = tracker.track_single_level(ref, ref)
    assert (flow == 0).all()
    assert tracker.last_stats["iterations"] == [1]
    pyr = build_pyramid(ref, 3, quantize=False, device="cpu")
    assert (tracker.track(pyr, pyr) == 0).all()


def test_track_matches_the_native_ground_truth(pair):
    """As tests/test_dense.py holds JAX to the native port."""
    if not cpu_baseline.available():
        pytest.skip("no C++ compiler for the native ground truth")
    ref, cur = pair
    rp = build_pyramid(ref, 3, quantize=False, device="cpu")
    cp = build_pyramid(cur, 3, quantize=False, device="cpu")
    opts = dense.DenseFlowOptions(half_patch_size=2, max_iterations=10)
    got = dense.DenseOpticalFlow(opts, device="cpu").track(rp, cp).numpy()
    want = cpu_baseline.farneback_cpu(rp, cp, opts)
    assert np.abs(_interior(got, 10) - _interior(want, 10)).mean() < 0.05


def test_dense_options_cross_from_jax():
    theirs = jdense.DenseFlowOptions(max_iterations=3, half_patch_size=1,
                                     max_converge_step=1e-3,
                                     max_delta_flow_step=0.5)
    ours = options_from_jax(theirs)
    assert type(ours) is dense.DenseFlowOptions
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert options_from_jax(jdense.DenseFlowOptions()) == \
        dense.DenseFlowOptions()


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense.DenseOpticalFlow()
