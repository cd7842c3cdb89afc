"""The port's native host runtime (C++ ring buffer, fused convert +
pyramid, timers), its frame stream, and its native CPU ground truth, held
to the JAX package's on the same inputs."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feature_tracker_tpu.core import config as jax_config
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.runtime import cpu_baseline as jax_baseline
from feature_tracker_tpu.trackers import dense as jdense
from feature_tracker_tpu.trackers import direct as jdirect
from feature_tracker_tpu_torch.convert import options_from_jax
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.runtime import (
    FrameStream,
    NativeRuntime,
    build_native,
    cpu_baseline,
    get_runtime,
)
from feature_tracker_tpu_torch.runtime import native

from synthetic import translated_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    built = build_native()
    r = get_runtime()
    if built:
        assert r.is_native, "library built but failed to load"
    return r


def test_native_builds_into_the_port_build_directory(rt):
    # The environment ships g++, so the native path must be real here.
    assert rt.is_native and cpu_baseline.available()
    for name, source, extra in (
            ("ftk_runtime", "ftk_runtime.cpp", ()),
            ("ftk_klt_baseline", "klt_cpu_baseline.cpp",
             ("-ffp-contract=off",))):
        path = native.host_library_path(name, source, extra)
        assert os.path.dirname(path) == native.BUILD_DIR
        assert os.path.basename(path).startswith(f"lib{name}-")
    assert native.NATIVE_DIR == os.path.join(REPO, "native")


def test_timer_monotonic(rt):
    a = rt.now_ns()
    b = rt.now_ns()
    assert b >= a


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_ring_buffer_fifo_and_capacity(rt, backend):
    ring = native.RingBuffer(3, 16, rt.lib if backend == "native" else None)
    frames = [np.full(16, i, np.uint8) for i in range(5)]
    assert ring.push(frames[0])
    assert ring.push(frames[1])
    assert ring.push(frames[2])
    assert not ring.push(frames[3])  # full -> dropped
    assert len(ring) == 3
    np.testing.assert_array_equal(ring.pop((16,)), frames[0])
    assert ring.push(frames[4])      # slot freed
    np.testing.assert_array_equal(ring.pop((16,)), frames[1])
    np.testing.assert_array_equal(ring.pop((16,)), frames[2])
    np.testing.assert_array_equal(ring.pop((16,)), frames[4])
    assert ring.pop((16,)) is None   # empty
    with pytest.raises(ValueError, match="bytes"):
        ring.push(np.zeros(15, np.uint8))


def test_convert_and_pyramid_matches_both_pyramids(rt):
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (96, 130), dtype=np.uint8)
    fallback = NativeRuntime()
    fallback.lib = None
    port = build_pyramid(frame, 4, quantize=True, device="cpu")
    jaxp = jax_pyramid(jnp.asarray(frame, jnp.float32), 4, quantize=True)
    for out in (rt.convert_and_pyramid(frame, levels=4),
                fallback.convert_and_pyramid(frame, levels=4)):
        assert len(out) == 4
        for a, b, c in zip(out, port, jaxp):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b.numpy())
            np.testing.assert_array_equal(a, np.asarray(c))


def test_frame_stream_end_to_end(rt):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (64, 80), dtype=np.uint8)
              for _ in range(6)]
    stream = FrameStream(iter(frames), levels=3, capacity=16)
    got = list(stream)
    # Capacity 16 > frame count: nothing dropped, all frames in order.
    assert len(got) == 6 and stream.dropped == 0
    for i, (fid, pyr) in enumerate(got):
        assert fid == i
        assert pyr[0].shape == (64, 80)
        assert pyr[2].shape == (16, 20)
        for a, b in zip(pyr, build_pyramid(frames[i], 3, device="cpu")):
            np.testing.assert_array_equal(a, b.numpy())
    assert list(FrameStream(iter([]))) == []


def test_frame_stream_drops_when_full():
    """With one ring slot and a slow consumer the producer drops frames
    rather than wait: every frame is either yielded, in order, or
    reported to ``on_drop``, and ``dropped`` counts the latter."""
    frames = [np.full((4, 4), i, np.uint8) for i in range(6)]
    dropped = []
    stream = FrameStream(iter(frames), levels=1, capacity=1,
                         on_drop=dropped.append)
    seen = []
    for fid, pyr in stream:
        assert fid == len(seen)
        seen.append(int(pyr[0][0, 0]))
        if fid == 0:
            stream._thread.join(timeout=10)   # let the producer fill up
    assert not stream._thread.is_alive()
    assert seen == sorted(seen) and seen[0] == 0
    assert sorted(seen + dropped) == list(range(6))
    assert stream.dropped == len(dropped) >= 4


@pytest.fixture(scope="module")
def pyramids():
    ref, cur = translated_pair(h=96, w=128, shift=(2.5, -1.5))
    return ([np.array(l) for l in jax_pyramid(jnp.asarray(ref), 3)],
            [np.array(l) for l in jax_pyramid(jnp.asarray(cur), 3)])


def _uv(n=40, seed=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-4, 132, n), rng.uniform(-4, 100, n)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("fn,extra", [
    ("klt_fast_cpu", {}), ("klt_affine_fast_cpu", {}),
    ("klt_lssd_fast_cpu", {}), ("klt_lssd_fast_cpu", {"luminance": True})])
def test_klt_ground_truth_equals_jax_packages(rt, pyramids, fn, extra):
    jopts = jax_config.KltOptions(max_track_points=35)
    status = np.zeros(40, np.int8)
    status[::5] = 3
    want = getattr(jax_baseline, fn)(*pyramids, _uv(), _uv() + 0.5, status,
                                     jopts, **extra)
    # Tensors in, numpy out.
    got = getattr(cpu_baseline, fn)(
        [torch.from_numpy(l) for l in pyramids[0]], pyramids[1],
        torch.from_numpy(_uv()), _uv() + 0.5, torch.from_numpy(status),
        options_from_jax(jopts), **extra)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 1).sum() > 10


def test_direct_and_farneback_ground_truth_equal_jax_packages(rt, pyramids):
    n = 30
    uv = _uv(n, seed=6)
    p_ref = np.concatenate([(uv - 64.0) / 100.0 * 4.0,
                            np.full((n, 1), 4.0, np.float32)], 1)
    k4 = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
    jopts = jdirect.DirectMethodOptions(max_track_points=25)
    want = jax_baseline.direct_method_cpu(*pyramids, k4, p_ref, uv,
                                          [1, 0, 0, 0], [0.01, 0, 0], jopts)
    got = cpu_baseline.direct_method_cpu(*pyramids, k4, p_ref, uv,
                                         [1, 0, 0, 0], [0.01, 0, 0],
                                         options_from_jax(jopts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dopts = jdense.DenseFlowOptions(max_iterations=5)
    np.testing.assert_array_equal(
        cpu_baseline.farneback_cpu(*pyramids, options_from_jax(dopts)),
        jax_baseline.farneback_cpu(*pyramids, dopts))
