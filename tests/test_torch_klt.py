"""CPU parity of the port's basic-KLT tracker with the JAX package.

The port's CPU path is the plain PyTorch version of its CUDA kernels
(trackers/klt/basic.py::track_pyramid_fast_reference and
track_pyramid_iter_reference). It is held against the JAX ``BasicKlt``
(whose CPU path is the jnp ``_basic_pyramid``) in all three solver modes,
against the Pallas kernels in interpret mode, and against the native C++
ground truth. Statuses must be equal and uv within 1e-3 px: only the order
of the patch sums differs between the implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.core.config import KltMethod as JaxMethod
from feature_tracker_tpu.core.config import KltOptions as JaxOptions
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.trackers.klt import BasicKlt as JaxBasicKlt
from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops import cuda_klt
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import BasicKlt
from feature_tracker_tpu_torch.trackers.klt.basic import (
    track_pyramid_fast_reference,
    track_pyramid_iter_reference,
)

from synthetic import translated_pair


def _pyramids(h, w, shift, levels):
    ref, cur = translated_pair(h=h, w=w, shift=shift)
    return (jax_pyramid(jnp.asarray(ref), levels),
            jax_pyramid(jnp.asarray(cur), levels),
            build_pyramid(ref, levels, device="cpu"),
            build_pyramid(cur, levels, device="cpu"))


def _features(n, h, w, margin, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)],
                    -1).astype(np.float32)


def _both(opts, pyrs, uv, cur_uv=None, status=None):
    jrp, jcp, trp, tcp = pyrs
    jopts = JaxOptions(**{k: getattr(opts, k) for k in
                          ("max_track_points", "max_iterations",
                           "max_tolerance_large_step", "patch_row_half_size",
                           "patch_col_half_size", "max_converge_step")},
                      method=JaxMethod(opts.method.value))
    j = JaxBasicKlt(jopts).track(
        jrp, jcp, jnp.asarray(uv),
        None if cur_uv is None else jnp.asarray(cur_uv),
        None if status is None else jnp.asarray(status))
    t = BasicKlt(opts, device="cpu").track(
        trp, tcp, uv, None if cur_uv is None else torch.from_numpy(cur_uv),
        None if status is None else torch.from_numpy(status))
    return (np.asarray(j[0]), np.asarray(j[1]), t[0].numpy(), t[1].numpy())


def _assert_same(ju, js, tu, ts):
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tu, ju, atol=1e-3)
    assert tu.dtype == np.float32 and ts.dtype == np.int8


@pytest.fixture(scope="module")
def pyrs():
    return _pyramids(120, 160, (3.0, -2.0), 3)


def test_basic_klt_matches_jax(pyrs):
    uv = _features(64, 120, 160, 8, seed=1)
    ju, js, tu, ts = _both(KltOptions(max_track_points=64), pyrs, uv)
    _assert_same(ju, js, tu, ts)
    assert (ts == int(TrackStatus.TRACKED)).sum() > 56
    tracked = ts == int(TrackStatus.TRACKED)
    flow = np.median(tu[tracked] - uv[tracked], axis=0)
    np.testing.assert_allclose(flow, [3.0, -2.0], atol=0.05)


def test_basic_klt_border_and_off_image(pyrs):
    uv = np.concatenate([_features(40, 120, 160, -3, seed=3),
                         [[-30.0, -30.0], [200.0, 20.0], [80.0, 60.0],
                          [-4000.0, 5000.0]]]).astype(np.float32)
    ju, js, tu, ts = _both(KltOptions(max_track_points=64), pyrs, uv)
    _assert_same(ju, js, tu, ts)
    assert list(ts[-4:]) == [3, 3, 1, 3]
    np.testing.assert_array_equal(tu[[-4, -3, -1]], uv[[-4, -3, -1]])


def test_skip_passthrough_of_poisoned_statuses(pyrs):
    uv = _features(48, 120, 160, 8, seed=5)
    cur_uv = uv + np.float32(0.5)
    status = np.zeros(48, np.int8)
    status[::4] = [2, 3, 4, 1] * 3   # failed lanes (2, 3, 4) are skipped
    ju, js, tu, ts = _both(KltOptions(max_track_points=48), pyrs, uv,
                           cur_uv, status)
    _assert_same(ju, js, tu, ts)
    failed = status > 1
    np.testing.assert_array_equal(ts[failed], status[failed])
    np.testing.assert_array_equal(tu[failed], cur_uv[failed])


def test_max_track_points_caps_tracking(pyrs):
    uv = _features(64, 120, 160, 8, seed=6)
    ju, js, tu, ts = _both(KltOptions(max_track_points=40), pyrs, uv)
    _assert_same(ju, js, tu, ts)
    np.testing.assert_array_equal(ts[40:], 0)
    np.testing.assert_array_equal(tu[40:], uv[40:])


def test_zero_features_and_shape_fallbacks(pyrs):
    _, _, trp, tcp = pyrs
    tracker = BasicKlt(KltOptions(), device="cpu")
    uv, st = tracker.track(trp, tcp, np.zeros((0, 2), np.float32))
    assert uv.shape == (0, 2) and st.shape == (0,) and st.dtype == torch.int8
    # Mis-shaped cur_uv / status fall back to ref_uv / NOT_TRACKED.
    ref_uv = _features(8, 120, 160, 10, seed=7)
    want = tracker.track(trp, tcp, ref_uv)
    got = tracker.track(trp, tcp, ref_uv, torch.zeros(3, 2),
                        torch.full((5,), 4, dtype=torch.int8))
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_wide_patch_matches_jax():
    pyrs = _pyramids(96, 128, (2.0, 1.5), 2)
    uv = _features(24, 96, 128, 4, seed=8)
    opts = KltOptions(max_track_points=24, patch_row_half_size=15)
    _assert_same(*_both(opts, pyrs, uv))


def test_single_level_and_stream_match_jax():
    ref, cur = translated_pair(h=80, w=112, shift=(1.0, 0.5))
    uv = _features(32, 80, 112, 6, seed=9)
    opts, jopts = KltOptions(max_track_points=32), JaxOptions(
        max_track_points=32)
    jr, jc = jnp.asarray(np.floor(ref)), jnp.asarray(np.floor(cur))
    ju, js = JaxBasicKlt(jopts).track_single_level(jr, jc, jnp.asarray(uv))
    tu, ts = BasicKlt(opts, device="cpu").track_single_level(
        np.floor(ref), np.floor(cur), uv)
    _assert_same(np.asarray(ju), np.asarray(js), tu.numpy(), ts.numpy())

    _, third = translated_pair(h=80, w=112, shift=(2.0, 1.0))
    frames = np.stack([ref, cur, third])
    ju, js = JaxBasicKlt(jopts).track_stream(frames, uv, levels=2)
    tu, ts = BasicKlt(opts, device="cpu").track_stream(frames, uv, levels=2)
    assert tu.shape == (2, 32, 2) and ts.shape == (2, 32)
    _assert_same(np.asarray(ju), np.asarray(js), tu.numpy(), ts.numpy())


def test_plain_version_matches_interpret_pallas():
    from feature_tracker_tpu.ops.pallas_klt import track_pyramid_fast_pallas

    jrp, jcp, trp, tcp = _pyramids(64, 96, (1.5, -1.0), 2)
    uv = _features(16, 64, 96, 2, seed=10)
    opts = KltOptions(max_track_points=16)
    pu, ps = track_pyramid_fast_pallas(JaxOptions(max_track_points=16), jrp,
                                       jcp, jnp.asarray(uv),
                                       jnp.asarray(uv), interpret=True)
    t = torch.from_numpy(uv)
    tu, ts = track_pyramid_fast_reference(opts, trp, tcp, t, t,
                                          torch.zeros(16, dtype=torch.bool))
    _assert_same(np.asarray(pu), np.asarray(ps), tu.numpy(), ts.numpy())


def test_matches_native_ground_truth():
    from feature_tracker_tpu.runtime.cpu_baseline import (
        available,
        klt_fast_cpu,
    )
    if not available():
        pytest.skip("native baseline not buildable")
    ref, cur = translated_pair(h=120, w=160, shift=(2.3, -1.7))
    trp = build_pyramid(ref, 3, device="cpu")
    tcp = build_pyramid(cur, 3, device="cpu")
    uv = _features(64, 120, 160, 3, seed=11)
    opts = KltOptions(max_track_points=64)
    gu, gs = klt_fast_cpu([l.numpy() for l in trp], [l.numpy() for l in tcp],
                          uv, opts=JaxOptions(max_track_points=64))
    tu, ts = BasicKlt(opts, device="cpu").track(trp, tcp, uv)
    _assert_same(gu, gs, tu.numpy(), ts.numpy())


def test_cpu_wrapper_takes_plain_version_without_launching(pyrs):
    _, _, trp, tcp = pyrs
    uv = torch.from_numpy(_features(16, 120, 160, 8, seed=12))
    skip = torch.zeros(16, dtype=torch.bool)
    skip[3] = True
    before = cuda_klt.track_pyramid_fast_cuda.launches
    got = cuda_klt.track_pyramid_fast_cuda(KltOptions(), trp, tcp, uv, uv,
                                           skip)
    want = track_pyramid_fast_reference(KltOptions(), trp, tcp, uv, uv, skip)
    assert cuda_klt.track_pyramid_fast_cuda.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][3]) == 0 and torch.equal(got[0][3], uv[3])


@pytest.mark.parametrize("divergence_counter", [True, False])
def test_engine_break_rules_match_jax(divergence_counter):
    """The batched GN scaffold against the JAX one (vmapped) on a synthetic
    step: per-feature rates that converge, oscillate, diverge or give NaN,
    lanes with no valid pixel, a lane done from the start, and an OUTSIDE
    break status once x exceeds 50."""
    import jax

    from feature_tracker_tpu.trackers.klt import engine as jax_engine
    from feature_tracker_tpu_torch.trackers.klt import engine

    rate = np.array([0.5, 1.0, 1.9, 2.1, np.nan, 0.5, 0.1, 1.5, 4.0, 0.9],
                    np.float32)
    n_valid = np.array([5, 5, 5, 5, 5, 0, 5, 5, 5, 5], np.int32)
    done0 = np.zeros(10, bool)
    done0[7] = True
    target = np.float32(2.0)
    state0 = np.zeros((10, 2), np.float32) + np.float32(0.25)
    status0 = np.full(10, 2, np.int8)
    opts = KltOptions(max_iterations=12)

    def jax_step(args):
        def step(state):
            r, nv = args
            v = (target - state) * r
            new = state + v
            brk = jnp.where(new[0] > 50.0, jnp.int8(3), jnp.int8(0))
            return jax_engine.StepResult(nv, v, new, brk)
        return step

    want = jax.vmap(lambda s0, st0, d0, r, nv: jax_engine.run_klt_iterations(
        jax_step((r, nv)), s0, st0, d0, JaxOptions(max_iterations=12),
        divergence_counter))(jnp.asarray(state0), jnp.asarray(status0),
                             jnp.asarray(done0), jnp.asarray(rate),
                             jnp.asarray(n_valid))

    t_rate = torch.from_numpy(rate)[:, None]

    def step(state):
        v = (target - state) * t_rate
        new = state + v
        brk = torch.where(new[:, 0] > 50.0, 3, 0).to(torch.int8)
        return engine.StepResult(torch.from_numpy(n_valid), v, new, brk)

    uv, st, steps = engine.run_klt_iterations(
        step, torch.from_numpy(state0), torch.from_numpy(status0),
        torch.from_numpy(done0), opts, divergence_counter)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want[1]))
    # The synthetic step's own arithmetic may round differently (XLA may
    # contract it into an FMA); the engine only selects among its results.
    np.testing.assert_allclose(uv.numpy(), np.asarray(want[0]), atol=1e-5)
    assert len(set(st.tolist())) >= 3  # several break rules fired
    assert steps[7] == 0 and steps.max() <= 12


ITERATIVE = [KltMethod.DIRECT, KltMethod.INVERSE]


@pytest.mark.parametrize("method", ITERATIVE)
def test_iterative_modes_match_jax(pyrs, method):
    uv = _features(64, 120, 160, 8, seed=21)
    ju, js, tu, ts = _both(KltOptions(max_track_points=64, method=method),
                           pyrs, uv)
    _assert_same(ju, js, tu, ts)
    tracked = ts == int(TrackStatus.TRACKED)
    assert tracked.sum() > 56
    flow = np.median(tu[tracked] - uv[tracked], axis=0)
    np.testing.assert_allclose(flow, [3.0, -2.0], atol=0.05)


@pytest.mark.parametrize("method", ITERATIVE)
def test_iterative_modes_keep_incoming_status(pyrs, method):
    """DIRECT/INVERSE keep the status a feature came in with unless a
    break rule sets another: with one iteration and an unreachable
    convergence threshold nothing converges, so TRACKED stays TRACKED and
    NOT_TRACKED stays NOT_TRACKED, while failed lanes are skipped."""
    uv = _features(48, 120, 160, 12, seed=22)
    status = np.zeros(48, np.int8)
    status[::3] = 1
    status[1::12] = [2, 3, 4, 2]
    opts = KltOptions(max_track_points=48, method=method, max_iterations=1,
                      max_converge_step=1e-12)
    ju, js, tu, ts = _both(opts, pyrs, uv, uv + np.float32(0.25), status)
    _assert_same(ju, js, tu, ts)
    np.testing.assert_array_equal(ts, status)
    assert np.abs(tu - uv).max() > 0.5  # the non-skipped lanes did move


@pytest.mark.parametrize("method", ITERATIVE)
def test_iterative_modes_border_off_image_and_outside_break(pyrs, method):
    """Border and off-image features, and features whose prediction sends
    them across the border of a coarse level, where the per-level OUTSIDE
    break fires."""
    uv = np.concatenate([_features(40, 120, 160, -3, seed=23),
                         [[-30.0, -30.0], [200.0, 20.0], [80.0, 60.0],
                          [-4000.0, 5000.0], [1.0, 1.0], [158.5, 118.0]]]
                        ).astype(np.float32)
    cur_uv = uv.copy()
    cur_uv[-2:] += np.float32([[-0.9, -0.9], [0.4, 0.9]])
    ju, js, tu, ts = _both(KltOptions(max_track_points=64, method=method),
                           pyrs, uv, cur_uv)
    _assert_same(ju, js, tu, ts)
    # No valid pixel: the chain leaves position and status untouched, and
    # the final check marks the off-image position OUTSIDE.
    assert list(ts[[-6, -5, -3]]) == [3, 3, 3]
    np.testing.assert_array_equal(tu[[-6, -5, -3]], uv[[-6, -5, -3]])
    assert ts[-4] == int(TrackStatus.TRACKED)
    # The image content moves these two across the border.
    assert list(ts[-2:]) == [3, 3]


@pytest.mark.parametrize("method", ITERATIVE)
def test_iterative_single_level_and_stream_match_jax(method):
    ref, cur = translated_pair(h=80, w=112, shift=(1.0, 0.5))
    uv = _features(32, 80, 112, 6, seed=24)
    opts = KltOptions(max_track_points=32, method=method)
    jopts = JaxOptions(max_track_points=32, method=JaxMethod(method.value))
    jr, jc = jnp.asarray(np.floor(ref)), jnp.asarray(np.floor(cur))
    ju, js = JaxBasicKlt(jopts).track_single_level(jr, jc, jnp.asarray(uv))
    tu, ts = BasicKlt(opts, device="cpu").track_single_level(
        np.floor(ref), np.floor(cur), uv)
    _assert_same(np.asarray(ju), np.asarray(js), tu.numpy(), ts.numpy())

    _, third = translated_pair(h=80, w=112, shift=(2.0, 1.0))
    frames = np.stack([ref, cur, third])
    ju, js = JaxBasicKlt(jopts).track_stream(frames, uv, levels=2)
    tu, ts = BasicKlt(opts, device="cpu").track_stream(frames, uv, levels=2)
    _assert_same(np.asarray(ju), np.asarray(js), tu.numpy(), ts.numpy())


@pytest.mark.parametrize("method", ITERATIVE)
def test_iter_plain_version_matches_interpret_pallas(method):
    from feature_tracker_tpu.ops.pallas_klt import track_pyramid_iter_pallas

    jrp, jcp, trp, tcp = _pyramids(64, 96, (1.5, -1.0), 2)
    uv = _features(16, 64, 96, 2, seed=25)
    status = np.zeros(16, np.int8)
    status[::5] = 1
    jopts = JaxOptions(max_track_points=16, method=JaxMethod(method.value))
    pu, ps = track_pyramid_iter_pallas(jopts, jrp, jcp, jnp.asarray(uv),
                                       jnp.asarray(uv), jnp.asarray(status),
                                       interpret=True)
    t = torch.from_numpy(uv)
    tu, ts = track_pyramid_iter_reference(
        KltOptions(max_track_points=16, method=method), trp, tcp, t, t,
        torch.from_numpy(status), torch.zeros(16, dtype=torch.bool))
    _assert_same(np.asarray(pu), np.asarray(ps), tu.numpy(), ts.numpy())


@pytest.mark.parametrize("method", ITERATIVE)
def test_iter_cpu_wrapper_takes_plain_version_without_launching(pyrs, method):
    _, _, trp, tcp = pyrs
    uv = torch.from_numpy(_features(16, 120, 160, 8, seed=26))
    skip = torch.zeros(16, dtype=torch.bool)
    skip[3] = True
    status = torch.zeros(16, dtype=torch.int8)
    status[3] = 4
    opts = KltOptions(method=method)
    before = cuda_klt.track_pyramid_iter_cuda.launches
    got = cuda_klt.track_pyramid_iter_cuda(opts, trp, tcp, uv, uv, status,
                                           skip)
    want, steps = track_pyramid_iter_reference(
        opts, trp, tcp, uv, uv, status, skip, with_steps=True)[::2]
    assert cuda_klt.track_pyramid_iter_cuda.launches == before
    assert torch.equal(got[0], want)
    assert int(got[1][3]) == 4 and torch.equal(got[0][3], uv[3])
    assert steps[3] == 0 and steps.max() <= 3 * opts.max_iterations
    with pytest.raises(ValueError, match="FAST"):
        cuda_klt.track_pyramid_iter_cuda(KltOptions(), trp, tcp, uv, uv,
                                         status, skip)
    with pytest.raises(ValueError, match="FAST"):
        cuda_klt.track_pyramid_fast_cuda(opts, trp, tcp, uv, uv, skip)


@pytest.mark.parametrize("method", [KltMethod.FAST] + ITERATIVE)
def test_track_level_matches_jax(pyrs, method):
    """The one-level function, all modes: FAST rewrites the incoming
    status, DIRECT/INVERSE keep it unless a break rule sets another."""
    from feature_tracker_tpu.trackers.klt import basic as jax_basic
    from feature_tracker_tpu_torch.trackers.klt import basic

    jrp, jcp, trp, tcp = pyrs
    uv = _features(32, 60, 80, 1, seed=27) - np.float32(0.5)
    cur_uv = uv + np.float32([0.4, -0.3])
    status = np.zeros(32, np.int8)
    status[::4] = 1
    ju, js = jax_basic.track_level(
        JaxOptions(method=JaxMethod(method.value)), jrp[1], jcp[1],
        jnp.asarray(uv), jnp.asarray(cur_uv), jnp.asarray(status))
    tu, ts = basic.track_level(
        KltOptions(method=method), trp[1], tcp[1], torch.from_numpy(uv),
        torch.from_numpy(cur_uv), torch.from_numpy(status))
    _assert_same(np.asarray(ju), np.asarray(js), tu.numpy(), ts.numpy())
    assert (ts == int(TrackStatus.TRACKED)).sum() > 24
