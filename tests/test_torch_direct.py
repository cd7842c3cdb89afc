"""CPU parity of the port's geometry and direct SE(3) pose tracker with the
JAX package: geometry within 1e-6, pose (q, p) within 1e-5, reprojected uv
within 1e-3 px, statuses equal; and the port's tracker against the port's
native CPU ground truth."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feature_tracker_tpu.core import geometry as jgeo
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.trackers import direct as jdirect
from feature_tracker_tpu_torch.convert import options_from_jax, tracker_from_jax
from feature_tracker_tpu_torch.core import geometry as geo
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.runtime import cpu_baseline
from feature_tracker_tpu_torch.trackers import direct

from chip_smoke import render_plane, small_quat
from synthetic import Texture

H, W = 240, 320
K4 = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
Z0 = 5.0
TEX_SCALE = 18.0  # world units -> texture pixels
POSE_TOL, UV_TOL = 1e-5, 1e-3


def _render_plane(tex, q_wc, p_wc):
    """A camera at (q_wc, p_wc) viewing the textured plane z = Z0."""
    return render_plane(tex, q_wc, p_wc, H, W, K4, Z0, TEX_SCALE)


Q_TRUE = small_quat([0, 1, 0], 0.01)
P_TRUE = np.array([0.12, -0.06, 0.08], np.float32)


@pytest.fixture(scope="module")
def scene():
    """tests/test_direct.py's scene: the reference and current views of the
    plane, a back-projected feature grid, and both packages' pyramids."""
    tex = Texture(11, min_period=8.0, max_period=80.0)
    ref = _render_plane(tex, np.array([1.0, 0, 0, 0]), np.zeros(3))
    cur = _render_plane(tex, Q_TRUE, P_TRUE)
    us = np.arange(50, W - 50, 20, dtype=np.float64)
    vs = np.arange(50, H - 50, 20, dtype=np.float64)
    gu, gv = np.meshgrid(us, vs)
    ref_uv = np.stack([gu.reshape(-1), gv.reshape(-1)], -1).astype(np.float32)
    p_ref = np.stack([(ref_uv[:, 0] - K4[2]) / K4[0] * Z0,
                      (ref_uv[:, 1] - K4[3]) / K4[1] * Z0,
                      np.full(len(ref_uv), Z0)], -1).astype(np.float32)
    return {"ref_uv": ref_uv, "p_ref": p_ref,
            "jax": (jax_pyramid(jnp.asarray(ref), 3),
                    jax_pyramid(jnp.asarray(cur), 3)),
            "port": (build_pyramid(ref, 3, device="cpu"),
                     build_pyramid(cur, 3, device="cpu"))}


def _assert_same(got, want):
    uv, q, p, st = got
    juv, jq, jp, jst = (np.asarray(x) for x in want)
    assert uv.dtype == torch.float32 and st.dtype == torch.int8
    assert q.shape == (4,) and p.shape == (3,) and uv.shape == juv.shape
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(uv.numpy(), juv, rtol=0, atol=UV_TOL)
    np.testing.assert_array_equal(st.numpy(), jst)


def _random_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {"q": q, "q2": rng.normal(size=(5, 4)).astype(np.float32),
            "v": rng.normal(size=(5, 3)).astype(np.float32),
            "small": (0.05 * rng.normal(size=(5, 3))).astype(np.float32),
            "xy": rng.normal(size=(5, 2)).astype(np.float32),
            "k4": np.array([500.0, 480.0, 320.0, 240.0], np.float32)}


GEOMETRY_CASES = {
    "quat_identity": lambda m, a: m.quat_identity(),
    "quat_normalize": lambda m, a: m.quat_normalize(a["q2"]),
    "quat_conjugate": lambda m, a: m.quat_conjugate(a["q2"]),
    "quat_multiply": lambda m, a: m.quat_multiply(a["q"], a["q2"]),
    # One quaternion broadcast against many vectors, as the tracker does.
    "quat_rotate": lambda m, a: m.quat_rotate(a["q"][:1], a["v"]),
    "quat_from_small_angle": lambda m, a: m.quat_from_small_angle(a["small"]),
    "quat_to_matrix": lambda m, a: m.quat_to_matrix(a["q"]),
    "pinhole_project": lambda m, a: m.pinhole_project(a["xy"], a["k4"]),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    args = _random_inputs(3)
    want = np.asarray(GEOMETRY_CASES[name](jgeo, args))
    got = GEOMETRY_CASES[name](geo, args)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    # Tensors in, the same values out.
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    np.testing.assert_array_equal(GEOMETRY_CASES[name](geo, targs).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("mode", ["direct", "inverse", "fast"])
def test_track_matches_jax(scene, mode):
    jopts = jdirect.DirectMethodOptions(method=jdirect.DirectMethodMode(mode))
    want = jdirect.DirectMethod(jopts).track(*scene["jax"], K4,
                                             scene["p_ref"], scene["ref_uv"])
    tracker = tracker_from_jax(jdirect.DirectMethod(jopts), device="cpu")
    got = tracker.track(*scene["port"], K4, scene["p_ref"], scene["ref_uv"])
    _assert_same(got, want)
    its = tracker.last_stats["iterations"]
    assert len(its) == 3 and all(1 <= i <= jopts.max_iterations for i in its)
    assert tracker.last_stats["host_syncs"] == sum(its)
    # The true pose, to tests/test_direct.py's limits.
    q, p = got[1].numpy(), got[2].numpy()
    assert np.linalg.norm(p - P_TRUE) < 0.02
    assert min(np.linalg.norm(q - Q_TRUE), np.linalg.norm(q + Q_TRUE)) < 5e-3
    assert (got[3].numpy() == 1).mean() > 0.9


def test_track_world_matches_jax(scene):
    q_wr = small_quat([0.3, -0.5, 0.8], 0.4)
    p_wr = np.array([1.0, -2.0, 0.5], np.float32)
    p_w = np.asarray(jgeo.quat_rotate(jnp.asarray(q_wr)[None],
                                      jnp.asarray(scene["p_ref"]))) + p_wr
    status = np.ones(len(scene["ref_uv"]), np.int8)
    status[3] = 4                                # kept unless outside
    want = jdirect.DirectMethod().track_world(
        *scene["jax"], K4, q_wr, p_wr, p_w, scene["ref_uv"], q_wr, p_wr,
        status=status)
    got = direct.DirectMethod(device="cpu").track_world(
        *scene["port"], K4, q_wr, p_wr, p_w, scene["ref_uv"], q_wr, p_wr,
        status=status)
    _assert_same(got, want)
    assert got[3][3] == 4


def test_track_with_fewer_track_points_matches_jax(scene):
    """Only the first ``max_track_points`` features count; a prediction
    and an initial pose are passed in."""
    opts = dict(max_track_points=20, max_iterations=6, patch_row_half_size=4,
                patch_col_half_size=3)
    cur_uv = scene["ref_uv"] + np.float32(1.5)
    q0 = small_quat([0, 1, 0], 0.005)
    p0 = np.array([0.05, 0.0, 0.0], np.float32)
    want = jdirect.DirectMethod(jdirect.DirectMethodOptions(**opts)).track(
        *scene["jax"], K4, scene["p_ref"], scene["ref_uv"], q0, p0, cur_uv)
    got = direct.DirectMethod(direct.DirectMethodOptions(**opts),
                              device="cpu").track(
        *scene["port"], K4, scene["p_ref"], scene["ref_uv"], q0, p0, cur_uv)
    _assert_same(got, want)


def test_non_positive_depths_stop_without_raising(scene):
    """Every depth <= 0: an empty system, a NaN step, the level ends at
    once with the pose unchanged, as in JAX."""
    p_ref = scene["p_ref"].copy()
    p_ref[:, 2] = -1.0
    p_ref[::2, 2] = 0.0
    want = jdirect.DirectMethod().track(*scene["jax"], K4, p_ref,
                                        scene["ref_uv"])
    tracker = direct.DirectMethod(device="cpu")
    got = tracker.track(*scene["port"], K4, p_ref, scene["ref_uv"])
    _assert_same(got, want)
    assert tracker.last_stats["iterations"] == [1, 1, 1]
    np.testing.assert_array_equal(got[1].numpy(), [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(got[0].numpy(), scene["ref_uv"])


@pytest.mark.parametrize("mode", ["direct", "inverse", "fast"])
def test_zero_features_keep_the_pose_as_jax(scene, mode):
    """No feature (an empty slice, a window without landmarks): empty
    outputs and the initial pose, as in JAX."""
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32))
    jopts = jdirect.DirectMethodOptions(
        method=jdirect.DirectMethodMode(mode))
    want = jdirect.DirectMethod(jopts).track(*scene["jax"], K4, *empty)
    got = direct.DirectMethod(options_from_jax(jopts), device="cpu").track(
        *scene["port"], K4, *empty)
    _assert_same(got, want)
    assert got[0].shape == (0, 2) and got[3].shape == (0,)


def test_direct_mode_matches_the_native_ground_truth(scene):
    if not cpu_baseline.available():
        pytest.skip("no C++ compiler for the native ground truth")
    got = direct.DirectMethod(device="cpu").track(
        *scene["port"], K4, scene["p_ref"], scene["ref_uv"])
    uv, q, p, st = cpu_baseline.direct_method_cpu(
        *scene["port"], K4, scene["p_ref"], scene["ref_uv"])
    np.testing.assert_allclose(got[1].numpy(), q, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got[2].numpy(), p, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got[0].numpy(), uv, rtol=0, atol=UV_TOL)
    np.testing.assert_array_equal(got[3].numpy(), st)


def test_direct_options_cross_from_jax():
    theirs = jdirect.DirectMethodOptions(
        max_track_points=7, max_iterations=3, patch_row_half_size=2,
        patch_col_half_size=5, max_converge_step=1e-4,
        max_converge_residual=1.5, method=jdirect.DirectMethodMode.FAST)
    ours = options_from_jax(theirs)
    assert type(ours) is direct.DirectMethodOptions
    assert ours.method is direct.DirectMethodMode.FAST
    assert dataclasses.asdict(ours) | {"method": None} == \
        dataclasses.asdict(theirs) | {"method": None}
    assert options_from_jax(jdirect.DirectMethodOptions()) == \
        direct.DirectMethodOptions()


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        direct.DirectMethod()
