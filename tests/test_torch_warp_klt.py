"""CPU parity of the port's affine and SE(2)/LSSD trackers with the JAX
package.

The port's CPU path is the plain PyTorch version of its CUDA kernels
(trackers/klt/affine.py::affine_track_level_reference, trackers/klt/
lssd.py::lssd_track_level_reference) and, for DIRECT/INVERSE, the same
plain PyTorch that runs on the card. It is held against the JAX trackers
(whose CPU path is the vmapped jnp code), against the native C++ ground
truth, and the level functions against each other.

Tolerances are those of tests/test_pallas_warp_klt.py: statuses equal,
uv / affine / t within 5e-3, rotation within 1e-4. The arithmetic per
pixel is the same. The 6x6 / 3x3 systems hold absolute pixel coordinates
and are ill-conditioned (cond ~1e8): the JAX package sums and solves them
in float32, where the order of the sums alone moves the solution, and the
port accumulates and solves them in float64, so the two differ by the JAX
path's own rounding and 1e-3 px does not hold everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.core.config import KltMethod as JaxMethod
from feature_tracker_tpu.core.config import KltOptions as JaxOptions
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.trackers.klt import AffineKlt as JaxAffineKlt
from feature_tracker_tpu.trackers.klt import BasicKlt as JaxBasicKlt
from feature_tracker_tpu.trackers.klt import LssdKlt as JaxLssdKlt
from feature_tracker_tpu.trackers.klt import affine as jax_affine
from feature_tracker_tpu.trackers.klt import lssd as jax_lssd
from feature_tracker_tpu.trackers.klt import multi as jax_multi
from feature_tracker_tpu_torch.convert import tracker_from_jax
from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.core.status import TrackStatus
from feature_tracker_tpu_torch.ops import cuda_warp_klt
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import (
    AffineKlt,
    BasicKlt,
    LssdKlt,
    affine,
    lssd,
    multi,
)

from synthetic import se2_pair, translated_pair

UV_TOL, ROT_TOL = 5e-3, 1e-4
METHODS = [KltMethod.FAST, KltMethod.INVERSE, KltMethod.DIRECT]
H, W, LEVELS, N = 96, 128, 2, 24


def _features(n, h, w, margin, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)],
                    -1).astype(np.float32)


def _opts(method=KltMethod.FAST, n=N, **kw):
    return (KltOptions(max_track_points=n, method=method, **kw),
            JaxOptions(max_track_points=n, method=JaxMethod(method.value),
                       **kw))


PAIRS = {
    "translated": lambda: translated_pair(h=H, w=W, shift=(2.0, -1.5)),
    "se2": lambda: se2_pair(h=H, w=W, theta=0.03, shift=(1.5, -0.8))[:2],
}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def scene(request):
    ref, cur = PAIRS[request.param]()
    return {
        "name": request.param, "ref": ref, "cur": cur,
        "jax": (jax_pyramid(jnp.asarray(ref), LEVELS),
                jax_pyramid(jnp.asarray(cur), LEVELS)),
        "torch": (build_pyramid(ref, LEVELS, device="cpu"),
                  build_pyramid(cur, LEVELS, device="cpu")),
        "uv": _features(N, H, W, 12, seed=31),
    }


def _trackers(kind, method, luminance=False, n=N, **kw):
    opts, jopts = _opts(method, n, **kw)
    if kind == "affine":
        return AffineKlt(opts, device="cpu"), JaxAffineKlt(jopts)
    return (LssdKlt(opts, luminance, device="cpu"),
            JaxLssdKlt(jopts, luminance))


def _assert_same(j, t, tracked_only=False):
    """Statuses equal and uv within UV_TOL; with ``tracked_only`` the uv of
    lanes that failed is not compared (a chain that diverges along the
    image border is chaotic: its end point magnifies rounding)."""
    ju, js = np.asarray(j[0]), np.asarray(j[1])
    tu, ts = t[0].numpy(), t[1].numpy()
    np.testing.assert_array_equal(ts, js)
    keep = ts <= int(TrackStatus.TRACKED) if tracked_only else slice(None)
    np.testing.assert_allclose(tu[keep], ju[keep], atol=UV_TOL)
    assert tu.dtype == np.float32 and ts.dtype == np.int8
    return tu, ts


KINDS = [("affine", False), ("lssd", False), ("lssd", True)]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind,luminance", KINDS)
def test_track_matches_jax(scene, kind, luminance, method):
    tracker, jtracker = _trackers(kind, method, luminance)
    uv = scene["uv"]
    j = jtracker.track(*scene["jax"], jnp.asarray(uv))
    t = tracker.track(*scene["torch"], uv)
    tu, ts = _assert_same(j, t)
    tracked = ts == int(TrackStatus.TRACKED)
    assert tracked.sum() >= N // 2
    # (The luminance means only approximately cancel and bias the SE(2)
    # tracker by a fraction of a pixel, in both packages alike.)
    if scene["name"] == "translated" and not luminance:
        flow = np.median(tu[tracked] - uv[tracked], axis=0)
        np.testing.assert_allclose(flow, [2.0, -1.5], atol=0.1)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind,luminance", KINDS)
def test_single_level_with_prediction_matches_jax(scene, kind, luminance,
                                                  method):
    """track_single_level starts from a non-identity predict_affine /
    predict_rotation."""
    tracker, jtracker = _trackers(kind, method, luminance)
    c, s = np.float32(np.cos(0.02)), np.float32(np.sin(0.02))
    if kind == "affine":
        pred = np.array([[1.01, 0.015], [-0.01, 0.99]], np.float32)
        tracker.predict_affine = pred
        jtracker.predict_affine = jnp.asarray(pred)
    else:
        pred = np.array([[c, -s], [s, c]], np.float32)
        tracker.predict_rotation = pred
        jtracker.predict_rotation = jnp.asarray(pred)
    uv = scene["uv"]
    cur_uv = uv + np.float32([1.0, -1.0])
    ref, cur = np.floor(scene["ref"]), np.floor(scene["cur"])
    j = jtracker.track_single_level(jnp.asarray(ref), jnp.asarray(cur),
                                    jnp.asarray(uv), jnp.asarray(cur_uv))
    t = tracker.track_single_level(ref, cur, uv, cur_uv)
    _assert_same(j, t)


@pytest.mark.parametrize("kind,luminance", KINDS)
def test_track_stream_matches_jax(kind, luminance):
    """Chained pairs; LSSD restarts every pair at the identity, not at the
    tracker's predict_rotation."""
    tracker, jtracker = _trackers(kind, KltMethod.FAST, luminance)
    if kind == "lssd":
        pred = np.array([[0.0, -1.0], [1.0, 0.0]], np.float32)
        tracker.predict_rotation = pred
        jtracker.predict_rotation = jnp.asarray(pred)
    ref, cur = translated_pair(h=H, w=W, shift=(1.0, 0.5))
    _, third = translated_pair(h=H, w=W, shift=(2.0, 1.0))
    frames = np.stack([ref, cur, third])
    uv = _features(N, H, W, 14, seed=32)
    status = np.zeros(N, np.int8)
    status[::6] = 3
    j = jtracker.track_stream(frames, uv, status, levels=LEVELS)
    t = tracker.track_stream(frames, uv, status, levels=LEVELS)
    tu, ts = _assert_same(j, t)
    assert tu.shape == (2, N, 2) and ts.shape == (2, N)
    np.testing.assert_array_equal(ts[:, ::6], 3)
    assert (ts[-1] == int(TrackStatus.TRACKED)).sum() >= N // 2


@pytest.mark.parametrize("kind,luminance", KINDS)
def test_skip_border_off_image_and_cap(scene, kind, luminance):
    tracker, jtracker = _trackers(kind, KltMethod.FAST, luminance, n=26)
    uv = np.concatenate([_features(22, H, W, -3, seed=33),
                         [[-30.0, -30.0], [200.0, 20.0], [64.0, 48.0],
                          [-4000.0, 5000.0], [70.0, 40.0], [50.0, 50.0]]]
                        ).astype(np.float32)
    status = np.zeros(len(uv), np.int8)
    status[[2, 5, 8]] = [2, 3, 4]
    cur_uv = uv + np.float32(0.25)
    j = jtracker.track(*scene["jax"], jnp.asarray(uv), jnp.asarray(cur_uv),
                       jnp.asarray(status))
    t = tracker.track(*scene["torch"], uv, cur_uv, status)
    tu, ts = _assert_same(j, t, tracked_only=True)
    np.testing.assert_array_equal(ts[[2, 5, 8]], [2, 3, 4])
    np.testing.assert_array_equal(tu[[2, 5, 8]], cur_uv[[2, 5, 8]])
    assert list(ts[[22, 23, 25]]) == [3, 3, 3]     # off-image
    assert list(ts[26:]) == [0, 0]                 # beyond max_track_points
    np.testing.assert_array_equal(tu[26:], cur_uv[26:])


def _flat_scene():
    """A pair with flat regions: zero gradients make H exactly singular
    while the patch still has valid pixels."""
    ref, cur = translated_pair(h=H, w=W, shift=(1.0, 0.5))
    ref, cur = ref.copy(), cur.copy()
    ref[:, :48] = 80.0     # flat left part: H = 0
    cur[:, :48] = 90.0
    ref[:40, 48:90] = np.arange(42, dtype=np.float32)[None, :] * 3  # dy = 0
    cur[:40, 48:90] = np.arange(42, dtype=np.float32)[None, :] * 3 + 2
    uv = np.array([[20.0, 30.0], [24.5, 60.25], [68.0, 18.0], [70.5, 20.5],
                   [100.0, 70.0], [110.0, 60.0], [10.0, 80.0]], np.float32)
    return ref, cur, uv


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind,luminance", KINDS)
def test_singular_systems_give_jax_status_and_raise_nothing(kind, luminance,
                                                            method):
    """Lanes with a singular H (flat patch, one-directional gradient): the
    solve must not raise, and the status must be JAX's."""
    ref, cur, uv = _flat_scene()
    tracker, jtracker = _trackers(kind, method, luminance, n=len(uv))
    j = jtracker.track_single_level(jnp.asarray(ref), jnp.asarray(cur),
                                    jnp.asarray(uv))
    t = tracker.track_single_level(ref, cur, uv)
    js, ts = np.asarray(j[1]), t[1].numpy()
    np.testing.assert_array_equal(ts, js)
    assert (ts[:2] == int(TrackStatus.NUMERIC_ERROR)).all()
    ok = ts == int(TrackStatus.TRACKED)
    np.testing.assert_allclose(t[0].numpy()[ok], np.asarray(j[0])[ok],
                               atol=UV_TOL)
    # A failed solve leaves the position where it was.
    np.testing.assert_array_equal(t[0].numpy()[:2], uv[:2])


def test_affine_level_function_matches_jax(scene):
    """The plain version of the affine kernel against the vmapped jnp
    level function: uv, affine and status, with a skip lane."""
    opts, jopts = _opts()
    uv = scene["uv"]
    cur_uv = uv + np.float32([0.5, -0.25])
    aff = np.tile(np.array([[1.02, 0.01], [-0.015, 0.98]], np.float32),
                  (N, 1, 1))
    jr, jc = scene["jax"][0][0], scene["jax"][1][0]
    ju, ja, js = jax_affine.track_level(
        jopts, jr, jc, jnp.asarray(uv), jnp.asarray(cur_uv),
        jnp.asarray(aff), jnp.zeros(N, jnp.int8))
    skip = torch.zeros(N, dtype=torch.bool)
    skip[4] = True
    before = cuda_warp_klt.affine_track_level_cuda.launches
    tu, ta, ts, steps = affine.affine_track_level_reference(
        opts, scene["torch"][0][0], scene["torch"][1][0],
        torch.from_numpy(uv), torch.from_numpy(cur_uv),
        torch.from_numpy(aff), skip, with_steps=True)
    wu, wa, ws = cuda_warp_klt.affine_track_level_cuda(
        opts, scene["torch"][0][0], scene["torch"][1][0],
        torch.from_numpy(uv), torch.from_numpy(cur_uv),
        torch.from_numpy(aff), skip)
    assert cuda_warp_klt.affine_track_level_cuda.launches == before
    assert torch.equal(wu, tu) and torch.equal(wa, ta) and torch.equal(ws, ts)
    keep = ~skip.numpy()
    np.testing.assert_array_equal(ts.numpy()[keep], np.asarray(js)[keep])
    np.testing.assert_allclose(tu.numpy()[keep], np.asarray(ju)[keep],
                               atol=UV_TOL)
    np.testing.assert_allclose(ta.numpy()[keep], np.asarray(ja)[keep],
                               atol=UV_TOL)
    assert int(ts[4]) == 0 and steps[4] == 0
    np.testing.assert_array_equal(tu.numpy()[4], cur_uv[4])
    np.testing.assert_array_equal(ta.numpy()[4], aff[4])
    assert 0 < steps.max() <= opts.max_iterations


@pytest.mark.parametrize("luminance", [False, True])
def test_lssd_level_function_matches_jax(scene, luminance):
    opts, jopts = _opts()
    uv = scene["uv"]
    c, s = np.float32(np.cos(0.01)), np.float32(np.sin(0.01))
    rot = np.tile(np.array([[c, -s], [s, c]], np.float32), (N, 1, 1))
    t0 = (uv + np.float32([0.5, -0.25])
          - np.einsum("nij,nj->ni", rot, uv)).astype(np.float32)
    jr, jc = scene["jax"][0][0], scene["jax"][1][0]
    jrot, jt, js = jax_lssd.track_level(
        jopts, luminance, jr, jc, jnp.asarray(uv), jnp.asarray(rot),
        jnp.asarray(t0), jnp.zeros(N, jnp.int8))
    skip = torch.zeros(N, dtype=torch.bool)
    skip[7] = True
    before = cuda_warp_klt.lssd_track_level_cuda.launches
    args = (opts, luminance, scene["torch"][0][0], scene["torch"][1][0],
            torch.from_numpy(uv), torch.from_numpy(rot),
            torch.from_numpy(t0), skip)
    trot, tt, ts, steps = lssd.lssd_track_level_reference(*args,
                                                          with_steps=True)
    wrot, wt, ws = cuda_warp_klt.lssd_track_level_cuda(*args)
    assert cuda_warp_klt.lssd_track_level_cuda.launches == before
    assert torch.equal(wrot, trot) and torch.equal(wt, tt)
    assert torch.equal(ws, ts)
    keep = ~skip.numpy()
    np.testing.assert_array_equal(ts.numpy()[keep], np.asarray(js)[keep])
    np.testing.assert_allclose(trot.numpy()[keep], np.asarray(jrot)[keep],
                               atol=ROT_TOL)
    np.testing.assert_allclose(tt.numpy()[keep], np.asarray(jt)[keep],
                               atol=UV_TOL)
    assert int(ts[7]) == 0 and steps[7] == 0
    np.testing.assert_array_equal(trot.numpy()[7], rot[7])
    np.testing.assert_array_equal(tt.numpy()[7], t0[7])


def test_wrappers_refuse_iterative_modes(scene):
    opts, _ = _opts(KltMethod.INVERSE)
    img = scene["torch"][0][0]
    uv = torch.from_numpy(scene["uv"])
    skip = torch.zeros(N, dtype=torch.bool)
    eye = torch.eye(2).expand(N, 2, 2).contiguous()
    with pytest.raises(ValueError, match="FAST mode only"):
        cuda_warp_klt.affine_track_level_cuda(opts, img, img, uv, uv, eye,
                                              skip)
    with pytest.raises(ValueError, match="FAST mode only"):
        cuda_warp_klt.lssd_track_level_cuda(opts, False, img, img, uv, eye,
                                            uv, skip)


@pytest.mark.parametrize("kind,luminance", KINDS)
def test_matches_native_ground_truth(kind, luminance):
    from feature_tracker_tpu.runtime import cpu_baseline

    if not cpu_baseline.available():
        pytest.skip("native baseline not buildable")
    ref, cur = translated_pair(h=120, w=160, shift=(2.3, -1.7))
    trp = build_pyramid(ref, 3, device="cpu")
    tcp = build_pyramid(cur, 3, device="cpu")
    uv = _features(48, 120, 160, 20, seed=34)
    tracker, _ = _trackers(kind, KltMethod.FAST, luminance, n=48)
    nrp, ncp = [l.numpy() for l in trp], [l.numpy() for l in tcp]
    jopts = JaxOptions(max_track_points=48)
    if kind == "affine":
        gu, gs = cpu_baseline.klt_affine_fast_cpu(nrp, ncp, uv, opts=jopts)
    else:
        gu, gs = cpu_baseline.klt_lssd_fast_cpu(nrp, ncp, uv, opts=jopts,
                                                luminance=luminance)
    tu, ts = tracker.track(trp, tcp, uv)
    _assert_same((gu, gs), (tu, ts))


def test_zero_features_and_shape_fallbacks(scene):
    for tracker in (AffineKlt(device="cpu"), LssdKlt(device="cpu"),
                    LssdKlt(KltOptions(method=KltMethod.DIRECT),
                            device="cpu")):
        uv, st = tracker.track(*scene["torch"], np.zeros((0, 2), np.float32))
        assert uv.shape == (0, 2) and st.shape == (0,)
        assert st.dtype == torch.int8
        want = tracker.track(*scene["torch"], scene["uv"][:6])
        got = tracker.track(*scene["torch"], scene["uv"][:6],
                            torch.zeros(3, 2),
                            torch.full((5,), 4, dtype=torch.int8))
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_trackers_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (BasicKlt, AffineKlt, LssdKlt):
        with pytest.raises(RuntimeError):
            cls()


@pytest.mark.parametrize("kind", ["basic", "basic-inverse", "affine", "lssd"])
def test_track_pairs_matches_per_pair_calls_and_jax(kind):
    """Two pairs in one composite call: equal to the JAX track_pairs, and
    to per-pair calls for features well inside their image. The SE(2)
    system holds absolute coordinates, which the composite shifts by the
    band offset: its solve is conditioned differently there, and it agrees
    with the per-pair call only to a fraction of a pixel."""
    method = KltMethod.INVERSE if kind == "basic-inverse" else KltMethod.FAST
    opts, jopts = _opts(method, n=2 * 16)
    cls, jcls = {"basic": (BasicKlt, JaxBasicKlt),
                 "basic-inverse": (BasicKlt, JaxBasicKlt),
                 "affine": (AffineKlt, JaxAffineKlt),
                 "lssd": (LssdKlt, JaxLssdKlt)}[kind]
    tracker, jtracker = cls(opts, device="cpu"), jcls(jopts)
    pairs = [translated_pair(h=H, w=W, shift=(2.0, -1.5), seed=0),
             translated_pair(h=H, w=W, shift=(-1.0, 1.0), seed=1)]
    rps = [build_pyramid(r, LEVELS, device="cpu") for r, _ in pairs]
    cps = [build_pyramid(c, LEVELS, device="cpu") for _, c in pairs]
    uv = np.stack([_features(16, H, W, 30, seed=35),
                   _features(16, H, W, 30, seed=36)])
    status = np.zeros((2, 16), np.int8)
    status[1, 3] = 4
    tu, ts = multi.track_pairs(tracker, rps, cps, uv, uv + np.float32(0.5),
                               status, gap=32)
    assert tu.shape == (2, 16, 2) and ts.shape == (2, 16)
    for k in range(2):
        pu, ps = tracker.track(rps[k], cps[k], uv[k],
                               uv[k] + np.float32(0.5), status[k])
        np.testing.assert_array_equal(ts[k].numpy(), ps.numpy())
        np.testing.assert_allclose(tu[k].numpy(), pu.numpy(),
                                   atol=0.25 if kind == "lssd" else UV_TOL)
    assert int(ts[1, 3]) == 4
    ju, js = jax_multi.track_pairs(
        jtracker, [jax_pyramid(jnp.asarray(r), LEVELS) for r, _ in pairs],
        [jax_pyramid(jnp.asarray(c), LEVELS) for _, c in pairs],
        jnp.asarray(uv), jnp.asarray(uv + np.float32(0.5)),
        jnp.asarray(status), gap=32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=UV_TOL)


def test_track_pairs_value_errors():
    ref, cur = translated_pair(h=H, w=W, shift=(1.0, 0.0))
    rp = build_pyramid(ref, LEVELS, device="cpu")
    cp = build_pyramid(cur, LEVELS, device="cpu")
    uv = np.zeros((2, 4, 2), np.float32) + 50
    tracker = BasicKlt(KltOptions(max_track_points=8), device="cpu")
    with pytest.raises(ValueError, match=r"ref_uv must be \[K=2, N, 2\]"):
        multi.track_pairs(tracker, [rp, rp], [cp, cp], uv[0])
    with pytest.raises(ValueError, match="gap"):
        multi.track_pairs(tracker, [rp, rp], [cp, cp], uv, gap=16)
    small = BasicKlt(KltOptions(max_track_points=7), device="cpu")
    with pytest.raises(ValueError, match="max_track_points"):
        multi.track_pairs(small, [rp, rp], [cp, cp], uv, gap=32)
    with pytest.raises(ValueError, match="identical pyramid shapes"):
        multi.build_composite_pyramids([rp, rp[:1]], gap=32)
    with pytest.raises(ValueError, match="divisible"):
        multi.build_composite_pyramids([rp, rp], gap=33)
    comp, band = multi.build_composite_pyramids([rp, rp], gap=32)
    assert band == H + 32
    assert [tuple(l.shape) for l in comp] == [(2 * (H + 32), W),
                                              (H + 32, W // 2)]
    assert torch.equal(comp[1][H // 2 + 16:H + 16], rp[1])


@pytest.mark.parametrize("kind", ["basic", "affine", "lssd"])
def test_tracker_from_jax_round_trip(scene, kind):
    jopts = JaxOptions(max_track_points=N, max_iterations=9,
                       patch_row_half_size=5,
                       method=JaxMethod.FAST if kind != "basic"
                       else JaxMethod.INVERSE)
    pred = np.array([[0.9995, -0.03], [0.03, 0.9995]], np.float32)
    if kind == "basic":
        jtracker = JaxBasicKlt(jopts)
    elif kind == "affine":
        jtracker = JaxAffineKlt(jopts)
        jtracker.predict_affine = jnp.asarray(pred)
    else:
        jtracker = JaxLssdKlt(jopts, consider_patch_luminance=True)
        jtracker.predict_rotation = jnp.asarray(pred)
    tracker = tracker_from_jax(jtracker, device="cpu")
    assert type(tracker).__name__ == type(jtracker).__name__
    assert tracker.device.type == "cpu"
    assert tracker.options.max_iterations == 9
    assert tracker.options.patch_row_half_size == 5
    assert tracker.options.method.value == jopts.method.value
    if kind == "affine":
        np.testing.assert_array_equal(tracker.predict_affine, pred)
    if kind == "lssd":
        np.testing.assert_array_equal(tracker.predict_rotation, pred)
        assert tracker.consider_patch_luminance is True
    uv = scene["uv"]
    ref, cur = np.floor(scene["ref"]), np.floor(scene["cur"])
    j = jtracker.track_single_level(jnp.asarray(ref), jnp.asarray(cur),
                                    jnp.asarray(uv))
    _assert_same(j, tracker.track_single_level(ref, cur, uv))
    with pytest.raises(TypeError, match="no port counterpart"):
        tracker_from_jax(object())


# --- the affine tracker's whole-pyramid wrapper -----------------------------


def test_affine_pyramid_wrapper_matches_tracker_and_jax(scene):
    """``affine_track_pyramid_cuda`` on CPU tensors is the plain level
    loop, which is what ``AffineKlt.track`` runs: bit for bit; and the JAX
    tracker within UV_TOL with equal statuses. With failed and capped
    (skipped) lanes."""
    from feature_tracker_tpu_torch.trackers import klt as torch_klt

    n_cap = N - 3
    tracker, jtracker = _trackers("affine", KltMethod.FAST, n=n_cap)
    uv = scene["uv"]
    status = np.zeros(N, np.int8)
    status[[2, 9]] = [4, 3]
    rp, cp = scene["torch"]
    tu, ts = tracker.track(rp, cp, uv, None, status)
    _assert_same(jtracker.track(*scene["jax"], jnp.asarray(uv), None,
                                jnp.asarray(status)), (tu, ts))

    uv_t, st_t = torch.from_numpy(uv), torch.from_numpy(status)
    skip = torch_klt._skip_mask(N, st_t, tracker.options)
    assert skip.sum() == 5
    eye = torch.eye(2).expand(N, 2, 2).contiguous()
    args = (tracker.options, rp, cp, uv_t, uv_t, eye, skip)
    before = cuda_warp_klt.affine_track_pyramid_cuda.launches
    wu, wa, ws = cuda_warp_klt.affine_track_pyramid_cuda(*args)
    assert cuda_warp_klt.affine_track_pyramid_cuda.launches == before
    ru, ra, rs, steps = affine.affine_track_pyramid_reference(
        *args, with_steps=True)
    assert torch.equal(wu, ru) and torch.equal(wa, ra) and torch.equal(ws, rs)
    fu, fs = torch_klt._finish(skip, uv_t, st_t, wu, ws, rp[0].shape)
    assert torch.equal(fu, tu) and torch.equal(fs, ts)
    # Skipped lanes: position and warp as given, NOT_TRACKED, no steps.
    assert torch.equal(wu[skip], uv_t[skip]) and torch.equal(wa[skip],
                                                             eye[skip])
    assert (ws[skip] == 0).all() and (steps[skip] == 0).all()
    assert 0 < steps.max() <= LEVELS * tracker.options.max_iterations


@pytest.mark.parametrize("levels", [1, 3])
def test_affine_pyramid_reference_is_the_level_loop(levels):
    """The plain whole-pyramid version against a level loop written out
    here: positions scaled down, doubled between levels, A carried."""
    ref, cur = PAIRS["se2"]()
    rp = build_pyramid(ref, levels, device="cpu")
    cp = build_pyramid(cur, levels, device="cpu")
    opts, _ = _opts()
    uv = torch.from_numpy(_features(N, H, W, 12, seed=37))
    cur_uv = uv + torch.tensor([0.75, -0.5])
    aff = torch.tensor([[1.01, 0.005], [-0.01, 0.99]]).expand(
        N, 2, 2).contiguous()
    skip = torch.zeros(N, dtype=torch.bool)
    skip[3] = True
    gu, ga, gs = cuda_warp_klt.affine_track_pyramid_cuda(
        opts, rp, cp, uv, cur_uv, aff, skip)
    scale = 2.0 ** (levels - 1)
    s_ref, s_cur, a = uv / scale, cur_uv / scale, aff
    for lvl in reversed(range(levels)):
        s_cur, a, st = affine.affine_track_level_reference(
            opts, rp[lvl], cp[lvl], s_ref, s_cur, a, skip)
        if lvl:
            s_ref, s_cur = s_ref * 2.0, s_cur * 2.0
    assert torch.equal(gu, s_cur) and torch.equal(ga, a)
    assert torch.equal(gs, st)
    assert torch.equal(gu[3], cur_uv[3]) and int(gs[3]) == 0


@pytest.mark.parametrize("method", METHODS)
def test_affine_pyramid_with_a_level_function_runs_the_level_loop(scene,
                                                                  method):
    """``affine_pyramid`` with ``level_fn`` (and DIRECT / INVERSE without)
    runs its Python level loop, one call per level, and in FAST mode gives
    what the whole-pyramid route gives."""
    from feature_tracker_tpu_torch.trackers import klt as torch_klt

    opts, _ = _opts(method)
    rp, cp = scene["torch"]
    uv = torch.from_numpy(scene["uv"])
    status = torch.zeros(N, dtype=torch.int8)
    calls = []

    def level_fn(*args, **kw):
        calls.append(args[1].shape)
        return affine.track_level(*args, **kw)

    lu, ls = torch_klt.affine_pyramid(opts, rp, cp, uv, uv, status,
                                      level_fn=level_fn)
    assert calls == [tuple(l.shape) for l in reversed(rp)]
    du, ds = torch_klt.affine_pyramid(opts, rp, cp, uv, uv, status)
    assert torch.equal(lu, du) and torch.equal(ls, ds)


def test_affine_pyramid_wrapper_refuses_iterative_modes(scene):
    opts, _ = _opts(KltMethod.DIRECT)
    rp, cp = scene["torch"]
    uv = torch.from_numpy(scene["uv"])
    with pytest.raises(ValueError, match="FAST mode only"):
        cuda_warp_klt.affine_track_pyramid_cuda(
            opts, rp, cp, uv, uv, torch.eye(2).expand(N, 2, 2).contiguous(),
            torch.zeros(N, dtype=torch.bool))


# --- the SE(2) tracker's whole-pyramid wrapper ------------------------------


@pytest.mark.parametrize("luminance", [False, True])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_lssd_pyramid_reference_is_the_level_loop(levels, luminance):
    """The plain whole-pyramid version against a level loop written out
    here: t = s_cur - R s_ref at the coarsest scale, R carried, s_ref and t
    doubled between levels, R ref_uv + t at the end."""
    ref, cur = PAIRS["se2"]()
    rp = build_pyramid(ref, levels, device="cpu")
    cp = build_pyramid(cur, levels, device="cpu")
    opts, _ = _opts()
    uv = torch.from_numpy(_features(N, H, W, 12, seed=38))
    cur_uv = uv + torch.tensor([0.75, -0.5])
    c, s = np.float32(np.cos(0.01)), np.float32(np.sin(0.01))
    rot = torch.tensor([[c, -s], [s, c]]).expand(N, 2, 2).contiguous()
    skip = torch.zeros(N, dtype=torch.bool)
    skip[3] = True
    gu, gr, gs, steps = lssd.lssd_track_pyramid_reference(
        opts, luminance, rp, cp, uv, cur_uv, rot, skip, with_steps=True)
    scale = 2.0 ** (levels - 1)
    s_ref = uv / scale
    r = rot
    t = cur_uv / scale - torch.einsum("nij,nj->ni", r, s_ref)
    for lvl in reversed(range(levels)):
        r, t, st = lssd.lssd_track_level_reference(
            opts, luminance, rp[lvl], cp[lvl], s_ref, r, t, skip)
        if lvl:
            s_ref, t = s_ref * 2.0, t * 2.0
    want = torch.stack([r[:, 0, 0] * uv[:, 0] + r[:, 0, 1] * uv[:, 1],
                        r[:, 1, 0] * uv[:, 0] + r[:, 1, 1] * uv[:, 1]],
                       -1) + t
    assert torch.equal(gu, want) and torch.equal(gr, r)
    assert torch.equal(gs, st)
    # The skipped lane keeps its rotation, moves by nothing and takes no
    # step; the others take at least one step at every level.
    assert torch.equal(gr[3], rot[3]) and int(gs[3]) == 0 and steps[3] == 0
    np.testing.assert_allclose(gu[3].numpy(), cur_uv[3].numpy(), atol=1e-4)
    assert (steps[~skip] >= levels).all()


@pytest.mark.parametrize("luminance", [False, True])
def test_lssd_pyramid_wrapper_matches_tracker_and_jax(scene, luminance):
    """``lssd_track_pyramid_cuda`` on CPU tensors is the plain level loop,
    which is what ``LssdKlt.track`` runs: bit for bit, with no launch; and
    the JAX tracker within UV_TOL with equal statuses. With failed and
    capped (skipped) lanes."""
    from feature_tracker_tpu_torch.trackers import klt as torch_klt

    tracker, jtracker = _trackers("lssd", KltMethod.FAST, luminance,
                                  n=N - 3)
    uv = scene["uv"]
    status = np.zeros(N, np.int8)
    status[[2, 9]] = [4, 3]
    rp, cp = scene["torch"]
    tu, ts = tracker.track(rp, cp, uv, None, status)
    _assert_same(jtracker.track(*scene["jax"], jnp.asarray(uv), None,
                                jnp.asarray(status)), (tu, ts))

    uv_t, st_t = torch.from_numpy(uv), torch.from_numpy(status)
    skip = torch_klt._skip_mask(N, st_t, tracker.options)
    assert skip.sum() == 5
    eye = torch.eye(2).expand(N, 2, 2).contiguous()
    args = (tracker.options, luminance, rp, cp, uv_t, uv_t, eye, skip)
    before = cuda_warp_klt.lssd_track_pyramid_cuda.launches
    wu, wr, ws = cuda_warp_klt.lssd_track_pyramid_cuda(*args)
    assert cuda_warp_klt.lssd_track_pyramid_cuda.launches == before
    ru, rr, rs = lssd.lssd_track_pyramid_reference(*args)
    assert torch.equal(wu, ru) and torch.equal(wr, rr) and torch.equal(ws, rs)
    fu, fs = torch_klt._finish(skip, uv_t, st_t, wu, ws, rp[0].shape)
    assert torch.equal(fu, tu) and torch.equal(fs, ts)
    assert torch.equal(wr[skip], eye[skip]) and (ws[skip] == 0).all()


@pytest.mark.parametrize("method", METHODS)
def test_lssd_pyramid_with_a_level_function_runs_the_level_loop(scene,
                                                                method):
    """``lssd_pyramid`` with ``level_fn`` (and DIRECT / INVERSE without)
    runs its Python level loop, one call per level, and in FAST mode gives
    what the whole-pyramid route gives."""
    from feature_tracker_tpu_torch.trackers import klt as torch_klt

    opts, _ = _opts(method)
    rp, cp = scene["torch"]
    uv = torch.from_numpy(scene["uv"])
    status = torch.zeros(N, dtype=torch.int8)
    calls = []

    def level_fn(*args, **kw):
        calls.append(args[2].shape)
        return lssd.track_level(*args, **kw)

    eye = torch.eye(2)
    lu, ls = torch_klt.lssd_pyramid(opts, True, rp, cp, uv, uv, status, eye,
                                    level_fn=level_fn)
    assert calls == [tuple(l.shape) for l in reversed(rp)]
    du, ds = torch_klt.lssd_pyramid(opts, True, rp, cp, uv, uv, status, eye)
    assert torch.equal(lu, du) and torch.equal(ls, ds)


def test_lssd_pyramid_wrapper_refuses_iterative_modes(scene):
    rp, cp = scene["torch"]
    uv = torch.from_numpy(scene["uv"])
    eye = torch.eye(2).expand(N, 2, 2).contiguous()
    for method in (KltMethod.DIRECT, KltMethod.INVERSE):
        opts, _ = _opts(method)
        with pytest.raises(ValueError, match="FAST mode only"):
            cuda_warp_klt.lssd_track_pyramid_cuda(
                opts, False, rp, cp, uv, uv, eye,
                torch.zeros(N, dtype=torch.bool))
