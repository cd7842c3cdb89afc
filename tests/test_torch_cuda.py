"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
built from source at first use and have no CPU mode); without them the
tests skip. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.ops import cuda_klt, cuda_warp_klt
from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
    lookup_correlation_cuda,
    staged_share,
)
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import (
    AffineKlt,
    BasicKlt,
    LssdKlt,
)
from feature_tracker_tpu_torch.trackers.klt.affine import (
    affine_track_level_reference,
    affine_track_pyramid_reference,
)
from feature_tracker_tpu_torch.trackers.klt.basic import (
    track_pyramid_fast_reference,
    track_pyramid_iter_reference,
)
from feature_tracker_tpu_torch.trackers.klt.lssd import (
    lssd_track_level_reference,
    lssd_track_pyramid_reference,
)

from chip_smoke import (
    boundary_locations,
    brief_pipeline,
    cotracker_clip,
    lookup_inputs,
    render_plane,
    scattered_locations,
    small_quat,
)
from synthetic import se2_pair, translated_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ref, cur = translated_pair(h=240, w=320, shift=(3.0, -2.0))
    return (build_pyramid(ref, 3, device="cuda"),
            build_pyramid(cur, 3, device="cuda"))


def _features(n, h, w, margin, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)],
                    -1).astype(np.float32)


# 13x13 and 13x5 keep a lane's pixels in registers; 19x13 (247 pixels) and
# 31x13 take the shared-memory path.
@pytest.mark.parametrize("opts", [KltOptions(),
                                  KltOptions(patch_row_half_size=9),
                                  KltOptions(patch_row_half_size=15),
                                  KltOptions(patch_col_half_size=2,
                                             max_iterations=4)])
def test_kernel_matches_plain_version(pair, opts):
    rp, cp = pair
    uv = torch.from_numpy(np.concatenate([
        _features(500, 240, 320, -4, seed=13),
        [[-30.0, -30.0], [400.0, 20.0], [-4096.0, -4096.0]]]
    ).astype(np.float32)).cuda()
    skip = torch.zeros(uv.shape[0], dtype=torch.bool, device="cuda")
    skip[::7] = True
    before = cuda_klt.track_pyramid_fast_cuda.launches
    ku, ks = cuda_klt.track_pyramid_fast_cuda(opts, rp, cp, uv, uv, skip)
    torch.cuda.synchronize()
    assert cuda_klt.track_pyramid_fast_cuda.launches == before + 1
    assert ku.dtype == torch.float32 and ks.dtype == torch.int8
    pu, ps = track_pyramid_fast_reference(opts, rp, cp, uv, uv, skip)
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    ku, pu = ku.cpu().numpy(), pu.cpu().numpy()
    # Sums run in another order on the card: a borderline feature may flip
    # at the convergence threshold.
    assert (ks != ps).sum() <= 1
    both = (ks == 1) & (ps == 1)
    assert np.abs(ku[both] - pu[both]).max() <= 1e-3
    sk = skip.cpu().numpy()
    np.testing.assert_array_equal(ks[sk], 0)
    np.testing.assert_array_equal(ku[sk], uv.cpu().numpy()[sk])


@pytest.mark.parametrize("opts", [KltOptions(max_iterations=8),
                                  KltOptions(patch_row_half_size=9,
                                             max_iterations=8)])
def test_kernel_on_the_border_matches_plain_version(pair, opts):
    """Features whose patches leave the image on every side, some skipped:
    the rectangles of valid taps shrink to nothing for some (OUTSIDE, or
    state and status kept), and the statuses are the plain version's."""
    rp, cp = pair
    xs = np.array([-9.0, -7.0, -6.5, -0.25, 0.0, 5.5, 6.0, 313.0, 318.5,
                   319.0, 325.0, 327.5], np.float32)
    ys = np.array([-9.0, -7.0, -0.5, 0.0, 6.0, 233.0, 239.0, 246.0, 248.5],
                  np.float32)
    uv = torch.from_numpy(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
                          ).cuda()
    n = uv.shape[0]
    skip = torch.from_numpy(np.arange(n) % 4 == 1).cuda()
    call = cuda_klt.track_pyramid_fast_cuda
    before = call.launches
    ku, ks = call(opts, rp, cp, uv, uv, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    pu, ps = track_pyramid_fast_reference(opts, rp, cp, uv, uv, skip)
    ksn, psn = ks.cpu().numpy(), ps.cpu().numpy()
    np.testing.assert_array_equal(ksn, psn)
    assert {1, 3} <= set(psn.tolist())     # tracked ones and outside ones
    np.testing.assert_allclose(ku.cpu().numpy(), pu.cpu().numpy(),
                               atol=1e-3)
    sk = skip.cpu().numpy()
    np.testing.assert_array_equal(ksn[sk], 0)
    np.testing.assert_array_equal(ku.cpu().numpy()[sk], uv.cpu().numpy()[sk])


def test_fast_phase_clocks_share_the_kernel_time(pair):
    rp, cp = pair
    uv = torch.from_numpy(_features(512, 240, 320, 10, seed=12)).cuda()
    skip = torch.zeros(512, dtype=torch.bool, device="cuda")
    before = cuda_klt.track_pyramid_fast_cuda.launches
    clocks = cuda_klt.fast_phase_clocks(KltOptions(), rp, cp, uv, uv, skip)
    assert cuda_klt.track_pyramid_fast_cuda.launches == before
    assert tuple(clocks["share"]) == cuda_klt.FAST_PHASES
    assert clocks["clocks"] > 0
    assert all(v >= 0 for v in clocks["share"].values())
    assert abs(sum(clocks["share"].values()) - 1.0) <= 1e-9
    assert clocks["share"]["level setup"] > 0
    assert clocks["share"]["step pixels"] > 0


def test_basic_klt_on_cuda_matches_cpu(pair):
    rp, cp = pair
    uv = _features(256, 240, 320, 2, seed=14)
    status = np.zeros(256, np.int8)
    status[::9] = 4
    opts = KltOptions(max_track_points=200)
    gu, gs = BasicKlt(opts).track(rp, cp, uv, None, status)
    assert gu.is_cuda and gs.is_cuda
    cu, cs = BasicKlt(opts, device="cpu").track(
        [l.cpu() for l in rp], [l.cpu() for l in cp], uv, None, status)
    gs, cs = gs.cpu().numpy(), cs.numpy()
    assert (gs != cs).sum() <= 1
    both = (gs == 1) & (cs == 1)
    assert np.abs(gu.cpu().numpy()[both] - cu.numpy()[both]).max() <= 1e-3
    np.testing.assert_array_equal(gs[200:], status[200:])  # not tracked


def test_zero_features_do_not_launch(pair):
    rp, cp = pair
    empty = torch.zeros((0, 2), device="cuda")
    before = cuda_klt.track_pyramid_fast_cuda.launches
    uv, st = cuda_klt.track_pyramid_fast_cuda(
        KltOptions(), rp, cp, empty, empty,
        torch.zeros(0, dtype=torch.bool, device="cuda"))
    assert uv.shape == (0, 2) and st.shape == (0,)
    assert cuda_klt.track_pyramid_fast_cuda.launches == before


def test_inputs_the_kernel_cannot_take_raise(pair):
    rp, cp = pair
    uv = torch.full((4, 2), 50.0, device="cuda")
    skip = torch.zeros(4, dtype=torch.bool, device="cuda")
    call = cuda_klt.track_pyramid_fast_cuda
    with pytest.raises(ValueError, match="float32"):
        call(KltOptions(), rp, cp, uv.double(), uv.double(), skip)
    with pytest.raises(ValueError, match="levels"):
        call(KltOptions(), rp * 3, cp * 3, uv, uv, skip)
    with pytest.raises(ValueError, match="device"):
        call(KltOptions(), rp, cp, uv, uv.cpu(), skip)
    with pytest.raises(ValueError, match="contiguous"):
        call(KltOptions(), tuple(l.t() for l in rp), tuple(l.t() for l in cp),
             uv, uv, skip)
    with pytest.raises(RuntimeError, match="launch failed"):
        call(KltOptions(patch_row_half_size=200, patch_col_half_size=200),
             rp, cp, uv, uv, skip)


# --- DIRECT / INVERSE basic KLT, affine and SE(2) kernels -------------------

ITERATIVE = [KltMethod.INVERSE, KltMethod.DIRECT]


def _mixed_features():
    """Interior, border, off-image and parked features."""
    return torch.from_numpy(np.concatenate([
        _features(500, 240, 320, -4, seed=15),
        [[-30.0, -30.0], [400.0, 20.0], [-4096.0, -4096.0]]]
    ).astype(np.float32)).cuda()


@pytest.mark.parametrize("method", ITERATIVE)
@pytest.mark.parametrize("patch", [{}, {"patch_row_half_size": 15},
                                   {"patch_col_half_size": 2,
                                    "max_iterations": 4}])
def test_iter_kernel_matches_plain_version(pair, method, patch):
    rp, cp = pair
    opts = KltOptions(method=method, **patch)
    uv = _mixed_features()
    n = uv.shape[0]
    skip = torch.zeros(n, dtype=torch.bool, device="cuda")
    skip[::7] = True
    status = torch.zeros(n, dtype=torch.int8, device="cuda")
    status[::3] = 1
    status[::7] = 4
    call = cuda_klt.track_pyramid_iter_cuda
    before = call.launches
    ku, ks = call(opts, rp, cp, uv, uv, status, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    assert ku.dtype == torch.float32 and ks.dtype == torch.int8
    pu, ps = track_pyramid_iter_reference(opts, rp, cp, uv, uv, status, skip)
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    ku, pu = ku.cpu().numpy(), pu.cpu().numpy()
    # Sums run in another order on the card: a borderline feature may flip
    # at the convergence threshold.
    assert (ks != ps).sum() <= 1
    both = (ks == 1) & (ps == 1)
    assert np.abs(ku[both] - pu[both]).max() <= 1e-3
    sk = skip.cpu().numpy()
    np.testing.assert_array_equal(ks[sk], status.cpu().numpy()[sk])
    np.testing.assert_array_equal(ku[sk], uv.cpu().numpy()[sk])


@pytest.fixture
def se2_images():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ref, cur = se2_pair(h=240, w=320, theta=0.005)[:2]
    return (build_pyramid(ref, 1, device="cuda")[0],
            build_pyramid(cur, 1, device="cuda")[0])


def _warp_agreement(ks, ps, pairs):
    """Statuses within 1 % and each (kernel, plain, tolerance) pair within
    its tolerance at the 99th percentile on commonly tracked lanes. Kernel
    and plain version accumulate their ill-conditioned 6x6 / 3x3 systems in
    float64, so they agree far better than this; the limits are those a
    float32 system could still meet."""
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    assert (ks != ps).sum() <= max(1, len(ks) // 100)
    both = (ks == 1) & (ps == 1)
    assert both.sum() > len(ks) // 2
    for k, p, tol in pairs:
        d = np.abs(k.cpu().numpy()[both] - p.cpu().numpy()[both])
        assert np.percentile(d.reshape(len(d), -1).max(1), 99) <= tol


@pytest.mark.parametrize("patch", [{}, {"patch_row_half_size": 9,
                                        "max_iterations": 6}])
def test_affine_kernel_matches_plain_version(se2_images, patch):
    ref, cur = se2_images
    opts = KltOptions(**patch)
    uv = _mixed_features()
    n = uv.shape[0]
    cur_uv = (uv + torch.tensor([1.0, -0.5], device="cuda")).contiguous()
    aff = torch.tensor([[1.01, 0.01], [-0.01, 0.99]],
                       device="cuda").expand(n, 2, 2).contiguous()
    skip = torch.zeros(n, dtype=torch.bool, device="cuda")
    skip[::7] = True
    call = cuda_warp_klt.affine_track_level_cuda
    before = call.launches
    ku, ka, ks = call(opts, ref, cur, uv, cur_uv, aff, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    assert ku.shape == (n, 2) and ka.shape == (n, 2, 2)
    assert ks.dtype == torch.int8
    pu, pa, ps = affine_track_level_reference(opts, ref, cur, uv, cur_uv,
                                              aff, skip)
    _warp_agreement(ks, ps, [(ku, pu, 1e-3), (ka, pa, 5e-3)])
    assert (ks[skip] == 0).all()
    assert torch.equal(ku[skip], cur_uv[skip])
    assert torch.equal(ka[skip], aff[skip])
    off = ks[-3:].cpu().tolist()
    assert off == [3, 3, 3]


@pytest.fixture
def se2_pyramids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ref, cur = se2_pair(h=240, w=320, theta=0.02, shift=(3.0, -2.0))[:2]
    return (build_pyramid(ref, 3, device="cuda"),
            build_pyramid(cur, 3, device="cuda"))


@pytest.mark.parametrize("patch", [{}, {"patch_row_half_size": 9}])
def test_affine_pyramid_kernel_matches_plain_level_loop(se2_pyramids, patch):
    rp, cp = se2_pyramids
    opts = KltOptions(**patch)
    uv = torch.from_numpy(np.concatenate([
        _features(2000, 240, 320, -4, seed=17),
        [[-30.0, -30.0], [400.0, 20.0], [-4096.0, -4096.0]]]
    ).astype(np.float32)).cuda()
    n = uv.shape[0]
    cur_uv = (uv + torch.tensor([1.0, -0.5], device="cuda")).contiguous()
    aff = torch.tensor([[1.005, 0.002], [-0.002, 0.995]],
                       device="cuda").expand(n, 2, 2).contiguous()
    skip = torch.zeros(n, dtype=torch.bool, device="cuda")
    skip[::7] = True
    call = cuda_warp_klt.affine_track_pyramid_cuda
    before = call.launches
    ku, ka, ks = call(opts, rp, cp, uv, cur_uv, aff, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    assert ku.shape == (n, 2) and ka.shape == (n, 2, 2)
    assert ks.dtype == torch.int8
    pu, pa, ps = affine_track_pyramid_reference(opts, rp, cp, uv, cur_uv,
                                                aff, skip)
    # Both sides accumulate and solve in float64: at most 0.1 % of the
    # statuses (at least 1) may flip at a threshold.
    ksn, psn = ks.cpu().numpy(), ps.cpu().numpy()
    assert (ksn != psn).sum() <= max(1, n // 1000)
    both = (ksn == 1) & (psn == 1)
    assert both.sum() > n // 2
    assert (ku - pu).abs().cpu().numpy()[both].max() <= 1e-3
    assert (ka - pa).abs().cpu().numpy()[both].max() <= 5e-3
    assert (ks[skip] == 0).all()
    assert torch.equal(ku[skip], cur_uv[skip])
    assert torch.equal(ka[skip], aff[skip])
    assert (ksn[-3:] == psn[-3:]).all() and ksn[-3] == 3   # off the image
    # The level loop through the one-level launches of the same kernel
    # gives the same bits.
    s_ref, s_cur, a = uv / 4.0, cur_uv / 4.0, aff
    for lvl in (2, 1, 0):
        s_cur, a, st = cuda_warp_klt.affine_track_level_cuda(
            opts, rp[lvl], cp[lvl], s_ref.contiguous(), s_cur.contiguous(),
            a, skip)
        if lvl:
            s_ref, s_cur = s_ref * 2.0, s_cur * 2.0
    assert torch.equal(s_cur, ku) and torch.equal(a, ka)
    assert torch.equal(st, ks)


def test_affine_tracker_launches_once_per_track(pair):
    rp, cp = pair
    uv = _features(256, 240, 320, 2, seed=18)
    pyramid = cuda_warp_klt.affine_track_pyramid_cuda
    level = cuda_warp_klt.affine_track_level_cuda
    before = (pyramid.launches, level.launches)
    tracker = AffineKlt(KltOptions(max_track_points=256))
    tracker.track(rp, cp, uv)
    assert (pyramid.launches, level.launches) == (before[0] + 1, before[1])
    tracker.track_single_level(rp[0], cp[0], uv)
    assert (pyramid.launches, level.launches) == (before[0] + 2, before[1])
    # DIRECT / INVERSE have no kernel: plain PyTorch, no launch.
    AffineKlt(KltOptions(method=KltMethod.INVERSE)).track(rp, cp, uv)
    assert (pyramid.launches, level.launches) == (before[0] + 2, before[1])


def test_affine_pyramid_zero_features_and_refused_inputs(pair):
    rp, cp = pair
    call = cuda_warp_klt.affine_track_pyramid_cuda
    e2 = torch.zeros((0, 2), device="cuda")
    before = call.launches
    out = call(KltOptions(), rp, cp, e2, e2,
               torch.zeros((0, 2, 2), device="cuda"),
               torch.zeros(0, dtype=torch.bool, device="cuda"))
    assert out[0].shape == (0, 2) and out[1].shape == (0, 2, 2)
    assert out[2].shape == (0,) and call.launches == before
    uv = torch.full((4, 2), 50.0, device="cuda")
    eye = torch.eye(2, device="cuda").expand(4, 2, 2)
    skip = torch.zeros(4, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        call(KltOptions(), rp, cp, uv, uv, eye, skip)       # expanded view
    eye = eye.contiguous()
    with pytest.raises(ValueError, match="levels"):
        call(KltOptions(), rp * 3, cp * 3, uv, uv, eye, skip)
    with pytest.raises(ValueError, match="levels"):
        call(KltOptions(), rp, cp[:2], uv, uv, eye, skip)
    with pytest.raises(ValueError, match="shape"):
        call(KltOptions(), rp, cp[::-1], uv, uv, eye, skip)
    with pytest.raises(ValueError, match="float32"):
        call(KltOptions(), rp, cp, uv.double(), uv.double(), eye, skip)
    with pytest.raises(ValueError, match="device"):
        call(KltOptions(), rp, cp, uv, uv.cpu(), eye, skip)
    with pytest.raises(ValueError, match="FAST mode only"):
        call(KltOptions(method=KltMethod.DIRECT), rp, cp, uv, uv, eye, skip)
    with pytest.raises(RuntimeError, match="launch failed"):
        call(KltOptions(patch_row_half_size=200, patch_col_half_size=200),
             rp, cp, uv, uv, eye, skip)
    assert call.launches == before


@pytest.mark.parametrize("luminance", [False, True])
def test_lssd_kernel_matches_plain_version(se2_images, luminance):
    ref, cur = se2_images
    opts = KltOptions()
    uv = _mixed_features()
    n = uv.shape[0]
    rot = torch.eye(2, device="cuda").expand(n, 2, 2).contiguous()
    t = torch.tensor([1.0, -0.5], device="cuda").expand(n, 2).contiguous()
    skip = torch.zeros(n, dtype=torch.bool, device="cuda")
    skip[::7] = True
    call = cuda_warp_klt.lssd_track_level_cuda
    before = call.launches
    kr, kt, ks = call(opts, luminance, ref, cur, uv, rot, t, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    assert kr.shape == (n, 2, 2) and kt.shape == (n, 2)
    pr, pt, ps = lssd_track_level_reference(opts, luminance, ref, cur, uv,
                                            rot, t, skip)
    # t absorbs R's error times the coordinate, so hold the position
    # R uv + t to 1e-3 px instead of t itself.
    def pos(r, tt):
        return torch.einsum("nij,nj->ni", r, uv) + tt
    _warp_agreement(ks, ps, [(pos(kr, kt), pos(pr, pt), 1e-3),
                             (kr, pr, 1e-4)])
    assert (ks[skip] == 0).all()
    assert torch.equal(kr[skip], rot[skip]) and torch.equal(kt[skip], t[skip])


# 13x13 keeps a lane's samples in registers; 19x13 (247 pixels) takes the
# shared-memory path.
@pytest.mark.parametrize("luminance", [False, True])
@pytest.mark.parametrize("patch", [{}, {"patch_row_half_size": 9}])
def test_lssd_pyramid_kernel_matches_plain_level_loop(se2_pyramids, patch,
                                                      luminance):
    rp, cp = se2_pyramids
    opts = KltOptions(**patch)
    uv = torch.from_numpy(np.concatenate([
        _features(2000, 240, 320, -4, seed=19),
        [[-30.0, -30.0], [400.0, 20.0], [-4096.0, -4096.0]]]
    ).astype(np.float32)).cuda()
    n = uv.shape[0]
    cur_uv = (uv + torch.tensor([1.0, -0.5], device="cuda")).contiguous()
    c, s = np.cos(0.01), np.sin(0.01)
    rot = torch.tensor([[c, -s], [s, c]], dtype=torch.float32,
                       device="cuda").expand(n, 2, 2).contiguous()
    skip = torch.zeros(n, dtype=torch.bool, device="cuda")
    skip[::7] = True
    call = cuda_warp_klt.lssd_track_pyramid_cuda
    before = call.launches
    ku, kr, ks = call(opts, luminance, rp, cp, uv, cur_uv, rot, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    assert ku.shape == (n, 2) and kr.shape == (n, 2, 2)
    assert ks.dtype == torch.int8
    pu, pr, ps = lssd_track_pyramid_reference(opts, luminance, rp, cp, uv,
                                              cur_uv, rot, skip)
    # Both sides accumulate and solve in float64: at most 0.1 % of the
    # statuses (at least 1) may flip at a threshold.
    ksn, psn = ks.cpu().numpy(), ps.cpu().numpy()
    assert (ksn != psn).sum() <= max(1, n // 1000)
    both = (ksn == 1) & (psn == 1)
    assert both.sum() > n // 2
    assert (ku - pu).abs().cpu().numpy()[both].max() <= 1e-3
    assert (kr - pr).abs().cpu().numpy()[both].max() <= 1e-4
    assert (ks[skip] == 0).all() and torch.equal(kr[skip], rot[skip])
    assert (ksn[-3:] == psn[-3:]).all() and ksn[-3] == 3   # off the image
    # The level loop through the one-level launches of the same kernel
    # gives the same bits.
    s_ref = uv / 4.0
    t = (cur_uv / 4.0 - torch.stack(
        [rot[:, 0, 0] * s_ref[:, 0] + rot[:, 0, 1] * s_ref[:, 1],
         rot[:, 1, 0] * s_ref[:, 0] + rot[:, 1, 1] * s_ref[:, 1]], -1))
    r = rot
    for lvl in (2, 1, 0):
        r, t, st = cuda_warp_klt.lssd_track_level_cuda(
            opts, luminance, rp[lvl], cp[lvl], s_ref.contiguous(), r,
            t.contiguous(), skip)
        if lvl:
            s_ref, t = s_ref * 2.0, t * 2.0
    loop_uv = torch.stack([r[:, 0, 0] * uv[:, 0] + r[:, 0, 1] * uv[:, 1],
                           r[:, 1, 0] * uv[:, 0] + r[:, 1, 1] * uv[:, 1]],
                          -1) + t
    assert torch.equal(loop_uv, ku) and torch.equal(r, kr)
    assert torch.equal(st, ks)


@pytest.mark.parametrize("luminance", [False, True])
def test_lssd_tracker_launches_once_per_track(pair, luminance):
    rp, cp = pair
    uv = _features(256, 240, 320, 2, seed=20)
    pyramid = cuda_warp_klt.lssd_track_pyramid_cuda
    level = cuda_warp_klt.lssd_track_level_cuda
    before = (pyramid.launches, level.launches)
    tracker = LssdKlt(KltOptions(max_track_points=256), luminance)
    tracker.track(rp, cp, uv)
    assert (pyramid.launches, level.launches) == (before[0] + 1, before[1])
    tracker.track_single_level(rp[0], cp[0], uv)
    assert (pyramid.launches, level.launches) == (before[0] + 2, before[1])
    # DIRECT / INVERSE have no kernel: plain PyTorch, no launch.
    LssdKlt(KltOptions(method=KltMethod.INVERSE), luminance).track(rp, cp,
                                                                   uv)
    assert (pyramid.launches, level.launches) == (before[0] + 2, before[1])


def test_lssd_pyramid_zero_features_and_refused_inputs(pair):
    rp, cp = pair
    call = cuda_warp_klt.lssd_track_pyramid_cuda
    e2 = torch.zeros((0, 2), device="cuda")
    before = call.launches
    out = call(KltOptions(), True, rp, cp, e2, e2,
               torch.zeros((0, 2, 2), device="cuda"),
               torch.zeros(0, dtype=torch.bool, device="cuda"))
    assert out[0].shape == (0, 2) and out[1].shape == (0, 2, 2)
    assert out[2].shape == (0,) and call.launches == before
    uv = torch.full((4, 2), 50.0, device="cuda")
    eye = torch.eye(2, device="cuda").expand(4, 2, 2)
    skip = torch.zeros(4, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        call(KltOptions(), False, rp, cp, uv, uv, eye, skip)  # expanded view
    eye = eye.contiguous()
    with pytest.raises(ValueError, match="levels"):
        call(KltOptions(), False, rp * 3, cp * 3, uv, uv, eye, skip)
    with pytest.raises(ValueError, match="shape"):
        call(KltOptions(), False, rp, cp[::-1], uv, uv, eye, skip)
    with pytest.raises(ValueError, match=r"rot must be \[N, 2, 2\]"):
        call(KltOptions(), False, rp, cp, uv, uv, uv, skip)
    with pytest.raises(ValueError, match="device"):
        call(KltOptions(), False, rp, cp, uv, uv.cpu(), eye, skip)
    with pytest.raises(ValueError, match="FAST mode only"):
        call(KltOptions(method=KltMethod.DIRECT), False, rp, cp, uv, uv, eye,
             skip)
    with pytest.raises(RuntimeError, match="launch failed"):
        call(KltOptions(patch_row_half_size=200, patch_col_half_size=200),
             True, rp, cp, uv, uv, eye, skip)
    assert call.launches == before


@pytest.mark.parametrize("method", ITERATIVE)
def test_iter_kernel_on_the_border_keeps_incoming_statuses(pair, method):
    """Features whose patches leave the image on every side, with every
    incoming status: the rectangle of counting pixels shrinks to nothing
    for some (state and status kept), and the kernel agrees with the plain
    version."""
    rp, cp = pair
    opts = KltOptions(method=method, max_iterations=8)
    xs = np.array([-7.0, -6.5, -0.25, 0.0, 5.5, 6.0, 313.0, 318.5, 319.0,
                   325.0], np.float32)
    ys = np.array([-7.0, -0.5, 0.0, 6.0, 233.0, 239.0, 246.0], np.float32)
    uv = torch.from_numpy(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
                          ).cuda()
    n = uv.shape[0]
    status = torch.from_numpy(np.arange(n) % 5).to(torch.int8).cuda()
    skip = status > 1
    call = cuda_klt.track_pyramid_iter_cuda
    before = call.launches
    ku, ks = call(opts, rp, cp, uv, uv, status, skip)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    pu, ps = track_pyramid_iter_reference(opts, rp, cp, uv, uv, status, skip)
    ksn, psn = ks.cpu().numpy(), ps.cpu().numpy()
    assert (ksn != psn).sum() <= 1
    same = ksn == psn
    np.testing.assert_allclose(ku.cpu().numpy()[same], pu.cpu().numpy()[same],
                               atol=1e-3)
    sk = skip.cpu().numpy()
    np.testing.assert_array_equal(ksn[sk], status.cpu().numpy()[sk])


@pytest.mark.parametrize("kernel", ["fast", "inverse", "direct", "lssd",
                                    "lssd-luminance"])
def test_redesigned_kernels_hold_16_warps_per_sm(pair, kernel):
    opts = KltOptions()
    if kernel == "fast":
        occ = cuda_klt.fast_occupancy(opts)
    elif kernel.startswith("lssd"):
        occ = cuda_warp_klt.lssd_occupancy(opts, kernel.endswith("luminance"))
    else:
        occ = cuda_klt.iter_occupancy(KltOptions(method=KltMethod(kernel)))
    assert occ["warps_per_sm"] >= 16, occ
    assert 0 < occ["registers"] <= 128


@pytest.mark.parametrize("kind", ["inverse", "direct", "affine", "lssd",
                                  "lssd-luminance"])
def test_trackers_on_cuda_match_cpu(pair, kind):
    rp, cp = pair
    uv = _features(256, 240, 320, 2, seed=16)
    status = np.zeros(256, np.int8)
    status[::9] = 4
    opts = KltOptions(max_track_points=200)

    def make(device):
        if kind == "affine":
            return AffineKlt(opts, device=device)
        if kind.startswith("lssd"):
            return LssdKlt(opts, kind.endswith("luminance"), device=device)
        return BasicKlt(KltOptions(max_track_points=200,
                                   method=KltMethod(kind)), device=device)

    gu, gs = make("cuda").track(rp, cp, uv, None, status)
    assert gu.is_cuda and gs.is_cuda
    cu, cs = make("cpu").track([l.cpu() for l in rp], [l.cpu() for l in cp],
                               uv, None, status)
    gs, cs = gs.cpu().numpy(), cs.numpy()
    assert (gs != cs).sum() <= 2
    both = (gs == 1) & (cs == 1)
    d = np.abs(gu.cpu().numpy()[both] - cu.numpy()[both]).max(1)
    assert np.percentile(d, 99) <= 1e-3 and d.max() <= 5e-2
    np.testing.assert_array_equal(gs[200:], status[200:])  # not tracked
    np.testing.assert_array_equal(gs[::9][:20], 4)         # skipped


def test_new_kernels_do_not_launch_on_zero_features(pair):
    rp, cp = pair
    e2 = torch.zeros((0, 2), device="cuda")
    e22 = torch.zeros((0, 2, 2), device="cuda")
    skip = torch.zeros(0, dtype=torch.bool, device="cuda")
    st = torch.zeros(0, dtype=torch.int8, device="cuda")
    calls = (cuda_klt.track_pyramid_iter_cuda,
             cuda_warp_klt.affine_track_level_cuda,
             cuda_warp_klt.lssd_track_level_cuda)
    before = [c.launches for c in calls]
    out = cuda_klt.track_pyramid_iter_cuda(
        KltOptions(method=KltMethod.DIRECT), rp, cp, e2, e2, st, skip)
    assert out[0].shape == (0, 2) and out[1].shape == (0,)
    out = cuda_warp_klt.affine_track_level_cuda(KltOptions(), rp[0], cp[0],
                                                e2, e2, e22, skip)
    assert out[1].shape == (0, 2, 2) and out[2].shape == (0,)
    out = cuda_warp_klt.lssd_track_level_cuda(KltOptions(), True, rp[0],
                                              cp[0], e2, e22, e2, skip)
    assert out[0].shape == (0, 2, 2) and out[1].shape == (0, 2)
    assert [c.launches for c in calls] == before


def test_inputs_the_new_kernels_cannot_take_raise(pair):
    rp, cp = pair
    uv = torch.full((4, 2), 50.0, device="cuda")
    eye = torch.eye(2, device="cuda").expand(4, 2, 2)
    skip = torch.zeros(4, dtype=torch.bool, device="cuda")
    st = torch.zeros(4, dtype=torch.int8, device="cuda")
    inverse = KltOptions(method=KltMethod.INVERSE)
    it = cuda_klt.track_pyramid_iter_cuda
    with pytest.raises(ValueError, match="int8"):
        it(inverse, rp, cp, uv, uv, st.int(), skip)
    with pytest.raises(ValueError, match="float32"):
        it(inverse, rp, cp, uv.double(), uv.double(), st, skip)
    with pytest.raises(ValueError, match="FAST"):
        it(KltOptions(), rp, cp, uv, uv, st, skip)
    huge = {"patch_row_half_size": 200, "patch_col_half_size": 200}
    with pytest.raises(RuntimeError, match="launch failed"):
        it(KltOptions(method=KltMethod.INVERSE, **huge), rp, cp, uv, uv, st,
           skip)
    aff = cuda_warp_klt.affine_track_level_cuda
    with pytest.raises(ValueError, match="contiguous"):
        aff(KltOptions(), rp[0], cp[0], uv, uv, eye, skip)  # expanded view
    with pytest.raises(ValueError, match=r"affine must be \[N, 2, 2\]"):
        aff(KltOptions(), rp[0], cp[0], uv, uv, uv, skip)
    with pytest.raises(ValueError, match="shape"):
        aff(KltOptions(), rp[0], cp[1], uv, uv, eye.contiguous(), skip)
    with pytest.raises(ValueError, match="FAST mode only"):
        aff(inverse, rp[0], cp[0], uv, uv, eye.contiguous(), skip)
    with pytest.raises(RuntimeError, match="launch failed"):
        aff(KltOptions(**huge), rp[0], cp[0], uv, uv, eye.contiguous(), skip)
    ls = cuda_warp_klt.lssd_track_level_cuda
    with pytest.raises(ValueError, match="device"):
        ls(KltOptions(), False, rp[0], cp[0], uv, eye.contiguous(), uv.cpu(),
           skip)
    with pytest.raises(ValueError, match="bool"):
        ls(KltOptions(), False, rp[0], cp[0], uv, eye.contiguous(), uv,
           skip.int())
    with pytest.raises(RuntimeError, match="launch failed"):
        ls(KltOptions(**huge), True, rp[0], cp[0], uv, eye.contiguous(), uv,
           skip)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# The serving shape's channels on a small map; the JAX test's odd sizes;
# C=96 with r=4 (a grid of 100: four chunks, the last of 4); C not a
# multiple of 4 (scalar reads) and radius 0; 3*7*9 = 189 queries, not a
# multiple of the block's warps.
@pytest.mark.parametrize("shape,radius,levels", [((2, 16, 24, 128), 3, 3),
                                                 ((2, 13, 22, 16), 3, 3),
                                                 ((1, 13, 22, 96), 4, 2),
                                                 ((1, 9, 11, 5), 0, 2),
                                                 ((3, 7, 9, 12), 2, 1)])
def test_raft_lookup_kernel_matches_plain_version(card, shape, radius,
                                                  levels):
    f0, pyr, locs = lookup_inputs(card, 20, *shape, levels)
    before = lookup_correlation_cuda.launches
    got = lookup_correlation_cuda(f0, pyr, locs, radius)
    torch.cuda.synchronize()
    assert lookup_correlation_cuda.launches == before + 1
    want = raft.lookup_correlation_otf(f0, pyr, locs, radius)
    k = 2 * radius + 1
    assert got.shape == want.shape == shape[:3] + (levels * k * k,)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # Only the order of the sum over channels differs (and the last bits of
    # the fraction, floored once here and per offset there).
    assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all(), (
        (got - want).abs().max())
    assert (got[0, 0, :5] == 0).all() and (got[-1, -1, -3:] == 0).all()
    assert (want[0, 0, :5] == 0).all()
    # The materialised volume gives the same samples.
    f1 = pyr[0]
    mat = raft.lookup_correlation(
        raft.compute_correlation_pyramid(f0, f1, levels), locs, radius)
    assert ((got - mat).abs() <= 1e-4 + 1e-4 * mat.abs()).all()


def _lookup_case(card, name):
    """(f0, pyramid, locations, radius, share of queries staged or None for
    'some but not all') of a named case of the tile-staged lookup."""
    wide = lookup_inputs(card, 24, 2, 27, 128, 64, 3, spread=0.25)
    if name == "smooth":             # 27 rows: not a multiple of the tile
        return (*wide, 3, 1.0)
    if name == "boundary":           # a tile straddles a 40 px boundary
        return (wide[0], wide[1], boundary_locations(wide[2], 60, 40.0), 3,
                1.0)
    if name == "scattered":          # windows too far apart to stage
        f0, pyr, locs = lookup_inputs(card, 33, 1, 56, 128, 32, 2,
                                      spread=0.25)
        return (f0, pyr, scattered_locations(locs), 3, None)
    if name == "noisy":              # small chunks
        return (*lookup_inputs(card, 25, 2, 27, 128, 64, 3, spread=4.0), 3,
                1.0)
    if name == "small-map":          # smaller than a tile
        return (*lookup_inputs(card, 26, 2, 5, 6, 32, 2, spread=1.0), 3, 1.0)
    if name == "c96":
        return (*lookup_inputs(card, 27, 2, 20, 30, 96, 3, spread=0.5), 3,
                1.0)
    if name == "c100":               # the last chunk holds 4 channels
        return (*lookup_inputs(card, 28, 1, 20, 30, 100, 2, spread=0.5), 3,
                1.0)
    if name == "c130":               # not a multiple of 4: per query
        return (*lookup_inputs(card, 29, 1, 13, 22, 130, 2, spread=1.0), 3,
                0.0)
    if name == "r4":
        return (*lookup_inputs(card, 30, 2, 20, 30, 64, 3, spread=0.5), 4,
                1.0)
    if name == "r4-off-map":
        return (*lookup_inputs(card, 31, 1, 13, 22, 96, 2), 4, 1.0)
    assert name == "one-level"
    return (*lookup_inputs(card, 32, 2, 20, 30, 32, 1, spread=2.0), 3, 1.0)


@pytest.mark.parametrize("name", ["smooth", "boundary", "scattered", "noisy",
                                  "small-map", "c96", "c100", "c130", "r4",
                                  "r4-off-map", "one-level"])
def test_raft_lookup_tile_staging_matches_plain_version(card, name):
    f0, pyr, locs, radius, want_share = _lookup_case(card, name)
    share = staged_share(locs, [p.shape[1:3] for p in pyr], radius,
                         f0.shape[-1])["queries"]
    if want_share is None:
        assert 0.0 < share < 1.0
    else:
        assert share == want_share
    before = lookup_correlation_cuda.launches
    got = lookup_correlation_cuda(f0, pyr, locs, radius)
    torch.cuda.synchronize()
    assert lookup_correlation_cuda.launches == before + 1
    want = raft.lookup_correlation_otf(f0, pyr, locs, radius)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all(), (
        (got - want).abs().max())


def test_raft_on_cuda_matches_cpu(card):
    cfg = raft.RaftConfig(
        max_iterations=3, low_memory=True, feature_channels=64,
        context_channels=64, hidden_channels=32,
        correlation_pyramid_levels=2, correlation_hidden_channels=32,
        correlation_out_channels=16, flow_hidden_channels=16,
        flow_out_channels=8, motion_out_channels=16,
        mask_hidden_channels=32)
    torch.manual_seed(21)
    cpu = raft.Raft(cfg, device="cpu")
    gpu = raft.Raft(cfg)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(22)
    base = rng.uniform(0, 255, (2, 72, 104)).astype(np.float32)
    ref, cur = base[:, 4:68, 4:100, None], base[:, 5:69, 2:98, None]
    before = lookup_correlation_cuda.launches
    got = gpu(ref, cur)
    assert lookup_correlation_cuda.launches == before + 3
    assert got.is_cuda and got.shape == (3, 2, 64, 96, 2)
    want = cpu(ref, cur)
    # float32 with TF32 off on both sides: sums in another order only.
    assert (got.cpu() - want).abs().max() <= 1e-3


def test_raft_lookup_inputs_the_kernel_cannot_take_raise(card):
    f0, pyr, locs = lookup_inputs(card, 23, 1, 8, 8, 8, 2, spread=1.0)
    before = lookup_correlation_cuda.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        lookup_correlation_cuda(f0.double(), pyr, locs, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        lookup_correlation_cuda(f0, pyr, locs.cpu(), 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        lookup_correlation_cuda(f0.permute(0, 2, 1, 3), pyr,
                                locs.permute(0, 2, 1, 3).contiguous(), 2)
    with pytest.raises(ValueError, match="locations"):
        lookup_correlation_cuda(f0, pyr, locs[:, :4], 2)
    with pytest.raises(ValueError, match="pyramid level"):
        lookup_correlation_cuda(f0, [pyr[0][..., :4].contiguous()], locs, 2)
    with pytest.raises(ValueError, match="levels"):
        lookup_correlation_cuda(f0, pyr * 5, locs, 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        lookup_correlation_cuda(f0, pyr, locs, 200)   # grid > shared memory
    empty = lookup_correlation_cuda(f0[:0], [p[:0] for p in pyr], locs[:0], 2)
    assert empty.shape == (0, 8, 8, 50)
    assert lookup_correlation_cuda.launches == before


# The slice of modules without a kernel of their own (matching, the direct
# method, Farnebäck): on the card they run the same torch operations as on
# the CPU, and are held to the CPU here (``card`` is the fixture above).

@pytest.mark.parametrize("response", [40.0, 10.0])
def test_brief_pipeline_card_equals_cpu(card, response):
    """Corners, BRIEF bits, match indices, matched uv and statuses equal."""
    from feature_tracker_tpu_torch.core.config import HarrisOptions

    ref, cur = translated_pair(h=240, w=320, shift=(7.0, -4.0))
    opts = HarrisOptions(min_feature_distance=20, min_valid_response=response)
    got = brief_pipeline(torch.from_numpy(ref).cuda(),
                         torch.from_numpy(cur).cuda(), opts, "cuda")
    want = brief_pipeline(torch.from_numpy(ref), torch.from_numpy(cur), opts,
                          "cpu")
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    assert (want[6] == 1).sum() >= 10


@pytest.mark.parametrize("mode", ["direct", "inverse", "fast"])
def test_direct_pose_card_matches_cpu(card, mode):
    """tests/test_direct.py's scene: q and p within 1e-5, uv within 1e-3
    px, statuses equal."""
    from synthetic import Texture

    from feature_tracker_tpu_torch.trackers.direct import (
        DirectMethod,
        DirectMethodMode,
        DirectMethodOptions,
    )

    k4 = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    tex = Texture(11, min_period=8.0, max_period=80.0)
    args = (240, 320, k4, 5.0, 18.0)
    ref = render_plane(tex, np.array([1.0, 0, 0, 0]), np.zeros(3), *args)
    cur = render_plane(tex, small_quat([0, 1, 0], 0.01),
                       np.array([0.12, -0.06, 0.08]), *args)
    gu, gv = np.meshgrid(np.arange(50, 270, 20.0), np.arange(50, 190, 20.0))
    uv = np.stack([gu.ravel(), gv.ravel()], -1).astype(np.float32)
    p_ref = np.concatenate([(uv - k4[2:]) / k4[:2] * 5.0,
                            np.full((len(uv), 1), 5.0)], 1).astype(np.float32)
    opts = DirectMethodOptions(method=DirectMethodMode(mode))
    got = DirectMethod(opts, device="cuda").track(
        build_pyramid(ref, 3, device="cuda"),
        build_pyramid(cur, 3, device="cuda"), k4, p_ref, uv)
    want = DirectMethod(opts, device="cpu").track(
        build_pyramid(ref, 3, device="cpu"),
        build_pyramid(cur, 3, device="cpu"), k4, p_ref, uv)
    for g, w, tol in zip(got, want, (1e-3, 1e-5, 1e-5, 0)):
        assert g.is_cuda
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=tol)


def test_farneback_card_matches_cpu_in_distribution(card):
    """Interior pixels: mean |d| <= 1e-3 px, 99th percentile <= 5e-3 px."""
    from feature_tracker_tpu_torch.trackers.dense import (
        DenseFlowOptions,
        DenseOpticalFlow,
    )

    ref, cur = translated_pair(h=240, w=320, shift=(3.0, -2.0))
    opts = DenseFlowOptions(half_patch_size=2, max_iterations=20)
    got = DenseOpticalFlow(opts, device="cuda").track(
        build_pyramid(ref, 4, quantize=False, device="cuda"),
        build_pyramid(cur, 4, quantize=False, device="cuda"))
    want = DenseOpticalFlow(opts, device="cpu").track(
        build_pyramid(ref, 4, quantize=False, device="cpu"),
        build_pyramid(cur, 4, quantize=False, device="cpu"))
    d = (got.cpu() - want).abs()[:, 20:-20, 20:-20].numpy()
    assert d.mean() <= 1e-3 and np.percentile(d, 99) <= 5e-3


# The neural models (no kernel of their own either): on the card they run
# the same torch operations as on the CPU, on the shipped weights.

@pytest.mark.parametrize("kind", ["superpoint", "disk"])
def test_detector_card_matches_cpu(card, kind):
    """uv and counts equal, descriptors within 1e-5."""
    from feature_tracker_tpu_torch.models.disk import DiskDetector
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPointDetector,
    )

    cls = SuperPointDetector if kind == "superpoint" else DiskDetector
    det = cls.from_file(device="cuda")
    det_cpu = cls(det.variables, device="cpu")
    img, _ = translated_pair(h=120, w=150)
    uv, desc, num = det.detect(img)
    want_uv, want_desc, want_num = det_cpu.detect(img)
    assert uv.is_cuda and int(num) == int(want_num) > 0
    assert torch.equal(uv.cpu(), want_uv)
    assert (desc.cpu() - want_desc).abs().max() <= 1e-5


@pytest.mark.parametrize("variant", range(4))
def test_nn_matcher_card_matches_cpu(card, variant):
    """LightGlue's valid scores within 1e-3 and masked ones NEG_INF, then
    matched uv and statuses equal, for each of the four variants."""
    from feature_tracker_tpu_torch.match.nn_matcher import (
        NNFeatureMatcher,
        NNMatcherModelType,
        NNMatcherOptions,
    )
    from feature_tracker_tpu_torch.models.lightglue import NEG_INF

    opts = NNMatcherOptions(model_type=NNMatcherModelType(variant))
    m = NNFeatureMatcher.from_file(opts, device="cuda")
    m_cpu = NNFeatureMatcher(opts, variables=m.variables, device="cpu")
    dim = m.cfg.descriptor_dim
    rng = np.random.default_rng(40 + variant)
    k0 = rng.uniform(0, 480, (64, 2)).astype(np.float32)
    d0 = rng.normal(0, 1, (64, dim)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    k1 = k0 + np.float32([7.0, -4.0])
    d1 = d0 + rng.normal(0, 0.05, d0.shape).astype(np.float32)
    m0, m1 = np.arange(64) < 56, np.arange(64) >= 8
    args = [torch.from_numpy(a) for a in (k0, d0, k1, d1, m0, m1)]
    got = m.scores(*[a.cuda() for a in args]).cpu()
    want = m_cpu.scores(*args)
    pair = torch.from_numpy(m0[:, None] & m1[None, :])
    assert (got - want).abs()[pair].max() <= 1e-3
    assert (got[~pair] == NEG_INF).all()
    order = [1, 3, 0, 2, 4, 5]                  # descriptors first
    uv, st = m.match(*[args[i].cuda() for i in order])
    want_uv, want_st = m_cpu.match(*[args[i] for i in order])
    assert torch.equal(st.cpu(), want_st) and torch.equal(uv.cpu(), want_uv)
    assert (want_st == 1).sum() > 20


@pytest.mark.parametrize("max_matches", [300, 3])
def test_fused_match_list_ties_on_card_equal_cpu(card, max_matches):
    """Planted ties (equal row maxima, column maxima and match scores) and
    -inf / NEG_INF rows resolve on the card as on the CPU."""
    from feature_tracker_tpu_torch.models.lightglue import (
        NEG_INF,
        fused_match_list,
        mutual_argmax_matches,
    )

    rng = np.random.default_rng(41)
    s = np.round(rng.uniform(-6, 0, (40, 33)), 1).astype(np.float32)
    s[1, 3] = s[1, 5] = 0.5
    s[4, 7] = s[6, 7] = 0.7
    s[8, 0] = s[9, 1] = 0.9
    s[2, :] = -np.inf
    s[10, :] = NEG_INF
    s[:, 8] = -np.inf
    scores = torch.from_numpy(s)
    idx = mutual_argmax_matches(scores.cuda(), -3.0)
    assert torch.equal(idx.cpu(), mutual_argmax_matches(scores, -3.0))
    pairs, sc = fused_match_list(scores.cuda(), -3.0, max_matches)
    want_pairs, want_sc = fused_match_list(scores, -3.0, max_matches)
    assert torch.equal(pairs.cpu(), want_pairs)
    assert torch.equal(sc.cpu(), want_sc)


def test_cotracker_card_matches_cpu(card):
    """Shipped weights, 8 frames of 96x96, 24 queries: each iteration from
    the CPU's positions within 1e-3 px and 1e-4 in the visibility logits;
    the whole run within those or twice the card's own spread under a
    one-ulp change of the video (models/cotracker.py)."""
    from feature_tracker_tpu_torch.models.cotracker import CoTracker
    from feature_tracker_tpu_torch.utils.weights import (
        load_cotracker_npz,
        shipped_cotracker_config,
        weights_path,
    )

    cfg = shipped_cotracker_config()
    gpu = CoTracker(cfg)
    gpu.load_state_dict(load_cotracker_npz(weights_path("cotracker.npz")))
    cpu = CoTracker(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    video, queries = cotracker_clip(8, 96, 96, 24)
    v, q = torch.from_numpy(video).cuda(), torch.from_numpy(queries).cuda()
    tracks, vis = gpu(v, q)
    want, want_vis, want_iters = cpu(video, queries,
                                     return_all_iterations=True)
    start = torch.from_numpy(queries)[None].expand(8, 24, 2)
    for k in range(cfg.iterations):
        step, step_vis = gpu.refine_step(v, q, start.cuda())
        assert (step.cpu() - want_iters[k]).abs().max() <= 1e-3
        start = want_iters[k]
    assert (step_vis.cpu() - want_vis).abs().max() <= 1e-4
    tracks2, vis2 = gpu(torch.nextafter(v, torch.full_like(v, np.inf)), q)
    spread = (tracks - tracks2).abs().max(), (vis - vis2).abs().max()
    assert (tracks.cpu() - want).abs().max() <= max(1e-3, 2 * spread[0])
    assert (vis.cpu() - want_vis).abs().max() <= max(1e-4, 2 * spread[1])


# The parallel layer (no kernel of its own): one rank in this process over
# its own NCCL group, and the bundle adjuster on the card.

@pytest.fixture
def card_mesh(card):
    import torch.distributed as dist

    from feature_tracker_tpu_torch.parallel import make_mesh

    yield make_mesh()
    dist.destroy_process_group()


def test_one_rank_sharded_fast_klt_is_the_unsharded_tracker(pair, card_mesh):
    from feature_tracker_tpu_torch.parallel import track_klt_sharded

    rp, cp = pair
    uv = torch.from_numpy(_features(1001, 240, 320, 10, seed=21)).cuda()
    tracker = BasicKlt(KltOptions(max_track_points=900))
    want = tracker.track(rp, cp, uv)
    cuda_klt.track_pyramid_fast_cuda.launches = 0
    got = track_klt_sharded(tracker, card_mesh, rp, cp, uv)
    assert cuda_klt.track_pyramid_fast_cuda.launches == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][900:] == 0).all()


def _noisy_window(num_poses=6, num_lm=512, obs=4, seed=0):
    """tests/test_parallel.py's ``_synthetic_ba`` (that file imports JAX):
    landmarks ahead of a forward-moving camera line, 0.3 px of noise on
    the observations, 0.05 on the initial poses (but the first) and
    landmarks."""
    rng = np.random.default_rng(seed)
    k4 = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    lm = np.stack([rng.uniform(-3, 3, num_lm), rng.uniform(-2, 2, num_lm),
                   rng.uniform(8, 16, num_lm)], -1).astype(np.float32)
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (num_poses, 1))
    t = np.stack([np.zeros(num_poses), np.zeros(num_poses),
                  -0.4 * np.arange(num_poses)], -1).astype(np.float32)
    idx = np.stack([rng.choice(num_poses, obs, replace=False)
                    for _ in range(num_lm)]).astype(np.int32)
    p_c = lm[:, None, :] + t[idx]
    uv = np.stack([k4[0] * p_c[..., 0] / p_c[..., 2] + k4[2],
                   k4[1] * p_c[..., 1] / p_c[..., 2] + k4[3]], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    t0 = t.copy()
    t0[1:] += rng.normal(0, 0.05, (num_poses - 1, 3))
    lm0 = lm + rng.normal(0, 0.05, lm.shape)
    return (q, t0.astype(np.float32), lm0.astype(np.float32), idx,
            uv.astype(np.float32), np.ones(idx.shape, bool), k4)


def _noisy_launcher_problem():
    """The launcher's problem at 4096 landmarks with 0.3 px of noise on
    the observations."""
    from feature_tracker_tpu_torch.parallel.scaling import _make_problem

    q, t, lm, idx, uv, mask, k4 = _make_problem(4096, 4, 8)
    uv = uv + np.random.default_rng(5).normal(0, 0.3, uv.shape).astype(
        np.float32)
    return q, t, lm, idx, uv, mask, k4


@pytest.mark.parametrize("problem,iterations", [("window", 8),
                                                ("launcher", 5)])
def test_bundle_adjust_card_matches_cpu_and_repeats(card, problem,
                                                    iterations):
    """Two runs on the card give the same bits; the card is within JAX's
    sharded tolerances of the CPU (q 1e-4; t 1e-3; landmarks rtol 1e-3,
    atol 5e-3) and its rms history within 1e-3 relative."""
    from feature_tracker_tpu_torch.parallel import BaOptions, bundle_adjust

    prob = (_noisy_window() if problem == "window"
            else _noisy_launcher_problem())
    opts = BaOptions(max_iterations=iterations, num_fixed_poses=2)
    first = [x.cpu().numpy() for x in bundle_adjust(*prob, opts)]
    again = [x.cpu().numpy() for x in bundle_adjust(*prob, opts)]
    cpu = [x.numpy() for x in bundle_adjust(*prob, opts, device="cpu")]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(first[0], cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(first[1], cpu[1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(first[2], cpu[2], rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(first[3], cpu[3], rtol=1e-3)
    assert first[3][-1] < first[3][0]


def test_make_mesh_without_a_card_raises(card):
    """With the card hidden, ``make_mesh()`` (device "cuda" by default)
    raises and names the way to the CPU; it does not fall back."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", "from feature_tracker_tpu_torch.parallel "
         "import make_mesh; make_mesh()"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


# --------------------------------------------------------------- training
# One train step on the card against the same step on the CPU from the
# same state, by chip_smoke.py's rules (``train_state_agree``: the loss
# within 1e-4 relative, the clipped gradients read from Adam's first
# moments within 1e-3 of each leaf's largest, the parameters where the
# gradient counts, the batch statistics).
TRAIN_TINY = raft.RaftConfig(max_iterations=2, feature_channels=16,
                             context_channels=16, hidden_channels=8,
                             correlation_pyramid_levels=2,
                             correlation_radius=1,
                             correlation_hidden_channels=8,
                             correlation_out_channels=4,
                             flow_hidden_channels=4, flow_out_channels=4,
                             motion_out_channels=4, mask_hidden_channels=8)


def _flow_batch(seed=0, b=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (b, h + 8, w + 8)).astype(np.float32)
    ref, cur = base[:, 4:h + 4, 4:w + 4, None], base[:, 6:h + 6, 3:w + 3, None]
    gt = np.broadcast_to(np.float32([1.0, -2.0]), (b, h, w, 2)).copy()
    return ref, cur, gt


@pytest.mark.parametrize("kind", ["supervised", "unsupervised"])
def test_raft_train_step_card_matches_cpu(card, kind):
    from chip_smoke import train_state_agree
    from feature_tracker_tpu_torch.train import raft_train

    tcfg = raft_train.RaftTrainConfig()
    start = raft_train.create_train_state(0, TRAIN_TINY, tcfg, None,
                                          device="cpu")
    ref, cur, gt = _flow_batch()
    if kind == "supervised":
        step, batch = raft_train.make_train_step(TRAIN_TINY, tcfg), (ref, cur,
                                                                     gt)
    else:
        step = raft_train.make_unsup_train_step(TRAIN_TINY, tcfg)
        batch = (ref, cur)
    on_card = start.to(card)
    got, got_m = step(on_card, *batch)
    want, want_m = step(start, *batch)
    assert got.params[next(iter(got.params))].device.type == card.type
    train_state_agree(f"{kind} step", got, want, got_m, want_m)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(on_card.leaves(), start.leaves()))


def test_raft_low_memory_train_step_card_matches_cpu(card):
    """Training with low_memory=True on the card: the step takes the
    plain, differentiable on-the-fly lookup (the CUDA kernel has no
    backward, and the JAX trainers off a TPU take the same route), and
    gives the CPU's step; the kernel is not launched."""
    import dataclasses

    from chip_smoke import train_state_agree
    from feature_tracker_tpu_torch.ops import cuda_raft_lookup
    from feature_tracker_tpu_torch.train import raft_train

    cfg = dataclasses.replace(TRAIN_TINY, low_memory=True)
    tcfg = raft_train.RaftTrainConfig()
    start = raft_train.create_train_state(0, cfg, tcfg, None, device="cpu")
    ref, cur, gt = _flow_batch()
    step = raft_train.make_train_step(cfg, tcfg)
    launches = cuda_raft_lookup.lookup_correlation_cuda.launches
    got, got_m = step(start.to(card), ref, cur, gt)
    want, want_m = step(start, ref, cur, gt)
    assert cuda_raft_lookup.lookup_correlation_cuda.launches == launches
    train_state_agree("low_memory supervised step", got, want, got_m,
                      want_m)


@pytest.mark.parametrize("name", ["superpoint", "disk", "lightglue"])
def test_model_trainer_step_card_matches_cpu(card, name):
    from chip_smoke import moments_agree
    from feature_tracker_tpu_torch.models.disk import Disk, DiskConfig
    from feature_tracker_tpu_torch.models.layers import flax_init_, flax_order
    from feature_tracker_tpu_torch.models.lightglue import (
        LightGlue,
        LightGlueConfig,
    )
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )
    from feature_tracker_tpu_torch.train import (
        disk_train,
        lightglue_train,
        superpoint_train,
    )

    rng = np.random.default_rng(3)
    if name == "superpoint":
        module, cls, cfg = superpoint_train, SuperPoint, SuperPointConfig(
            descriptor_dim=32)
        tcfg = module.SuperPointTrainConfig()
        imgs, labs = zip(*(module.synthetic_corners_image(rng, 32, 32)
                           for _ in range(2)))
        batch = (np.stack(imgs)[..., None],
                 np.stack([module.corner_label_map(c, 32, 32) for c in labs]))
    elif name == "disk":
        module, cls, cfg = disk_train, Disk, DiskConfig(
            descriptor_dim=16, base_channels=8, depth=2)
        tcfg = module.DiskTrainConfig(num_samples=24)
        a, b, (dx, dy) = module.translated_training_pair(rng, 32, 32)
        uv = rng.uniform(6, 26, (24, 2)).astype(np.float32)
        batch = (a, b, uv, uv + np.float32([dx, dy]))
    else:
        module, cls, cfg = lightglue_train, LightGlue, LightGlueConfig(
            descriptor_dim=16, model_dim=32, num_heads=2, depth=2)
        tcfg = module.LightGlueTrainConfig()
        batch = module.synthetic_matching_problem(rng, 24, 24, 16, 14)
    model_cpu = flax_init_(cls(cfg, device="cpu"), 4)
    params = {k: v.clone() for k, v in
              flax_order(model_cpu.state_dict()).items()}
    step_cpu, tx = module.make_train_step(model_cpu, tcfg)
    step_card, _ = module.make_train_step(cls(cfg, device=card), tcfg)
    opt = tx.init(params)
    p_d, o_d, _ = step_card({k: v.to(card) for k, v in params.items()},
                            {"count": opt["count"].to(card),
                             "mu": {k: v.to(card) for k, v in
                                    opt["mu"].items()},
                             "nu": {k: v.to(card) for k, v in
                                    opt["nu"].items()}}, *batch)
    p_c, o_c, _ = step_cpu(params, opt, *batch)
    moments_agree(name, (p_d, o_d), (p_c, o_c))


# ------------------------------------------------------------ pretraining
# SuperPoint's training mode and the pretraining steps on the card against
# the CPU (chip_smoke.py's phase 10 rules: ``step_card_vs_cpu`` holds the
# loss within 1e-4 relative and the moments by ``moments_agree``, within
# twice the CPU's one-ulp spread where that is larger).
def test_superpoint_training_mode_card_matches_cpu(card):
    from chip_smoke import (
        SP_TRAIN_DESC_TOL,
        SP_TRAIN_HEAT_TOL,
        TRAIN_STATS_ATOL,
        TRAIN_STATS_RTOL,
    )
    from feature_tracker_tpu_torch.models.layers import flax_init_
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )

    cfg = SuperPointConfig(descriptor_dim=32)
    state = flax_init_(SuperPoint(cfg, device="cpu"), 5).state_dict()
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (3, 48, 64, 1)).astype(np.float32)
    outs = []
    for dev in (card, torch.device("cpu")):
        model = SuperPoint(cfg, device=dev)
        model.load_state_dict(state)
        outs.append(model(images, train=True))
    ((heat_d, desc_d), stats_d), ((heat_c, desc_c), stats_c) = outs
    assert heat_d.requires_grad and list(stats_d) == list(stats_c)
    heat_d, desc_d, heat_c, desc_c = (t.detach() for t in (heat_d, desc_d,
                                                           heat_c, desc_c))
    assert float((heat_d.cpu() - heat_c).abs().max()) <= SP_TRAIN_HEAT_TOL
    assert (float((desc_d.cpu() - desc_c).abs().max())
            <= SP_TRAIN_DESC_TOL * float(desc_c.abs().max()))
    for k, v in stats_c.items():
        assert bool(((stats_d[k].cpu() - v).abs()
                     <= TRAIN_STATS_RTOL * v.abs() + TRAIN_STATS_ATOL).all())


@pytest.mark.parametrize("kind", ["cells", "points", "distill"])
def test_superpoint_pretrain_step_card_matches_cpu(card, kind):
    from chip_smoke import captured_pools, pool_batches, step_card_vs_cpu
    from feature_tracker_tpu_torch.models.layers import flax_order
    from feature_tracker_tpu_torch.models.superpoint import SuperPoint
    from feature_tracker_tpu_torch.train import pretrain
    from feature_tracker_tpu_torch.train.optim import ClipAdamW
    from feature_tracker_tpu_torch.utils.weights import (
        load_superpoint_npz,
        weights_path,
    )

    state = flax_order(load_superpoint_npz(weights_path("superpoint.npz")))
    models = [SuperPoint(device=d) for d in (card, "cpu")]
    kw = dict(h=32, w=32, batch=2, pool_size=4)
    tx = ClipAdamW(1e-4, weight_decay=1e-5)
    if kind == "distill":
        pool = captured_pools(pretrain.distill_superpoint_from_disk,
                              models[0], state, steps=0, n_warps=3, **kw)[0]
        steps = [pretrain._make_sp_distill_step(m, tx) for m in models]
    else:
        pool = captured_pools(pretrain.adapt_superpoint, models[0], state,
                              rounds=1, steps=0, n_warps=3,
                              point_desc=kind == "points", **kw)[0]
        steps = [pretrain._make_sp_step(m, tx, 4, 4,
                                        point_desc=kind == "points")
                 for m in models]
    step_card_vs_cpu(f"SuperPoint {kind} step", card, *steps, state,
                     tx.init(state), pool_batches(pool, 2)[0], (0, 1))


def test_cotracker_train_step_card_matches_cpu(card):
    """From Flax's initializers with the heads (zero there) drawn N(0, 0.05),
    so that the gradients reach every leaf; at this width the flow
    embedding's frequencies stay low enough for the global norm to be
    finite, and every leaf's moments are held."""
    from chip_smoke import step_card_vs_cpu
    from feature_tracker_tpu_torch.models.cotracker import (
        CoTracker,
        CoTrackerConfig,
    )
    from feature_tracker_tpu_torch.train import cotracker_pretrain
    from feature_tracker_tpu_torch.train.optim import (
        ClipAdamW,
        warmup_cosine_schedule,
    )

    cfg = CoTrackerConfig(feature_dim=32, model_dim=32, depth=1,
                          iterations=2)
    tx = ClipAdamW(warmup_cosine_schedule(1e-3, 1, 10, end_value=1e-6),
                   weight_decay=1e-4)
    params = cotracker_pretrain.init_params(CoTracker(cfg, device="cpu"), 3)
    rng = np.random.default_rng(9)
    params = {k: (torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape))
                                   .astype(np.float32))
                  if k.startswith(("update.delta_head.", "update.vis_head."))
                  else v) for k, v in params.items()}
    steps = []
    for dev in (card, "cpu"):
        step = cotracker_pretrain.make_train_step(CoTracker(cfg, device=dev),
                                                  tx)

        def run(p, opt_state, *batch, _step=step):
            p, _, opt_state, loss, _ = _step(p, p, opt_state, *batch)
            return p, opt_state, loss

        steps.append(run)
    pool = cotracker_pretrain.make_pool(np.random.default_rng(3), 1, 2, 4,
                                        32, 32, 6, wide_motion=True,
                                        device="cpu")
    _, opt = step_card_vs_cpu("CoTracker step", card, *steps, params,
                              tx.init(params), pool[0], (0,))
    assert all(float(v.abs().max()) > 0 for v in opt["mu"].values())


# The port's timing and evaluation scripts (feature_tracker_tpu_torch/
# scripts/) at small shapes: each mode on the card against the same mode
# on the CPU, with the kernels' launches per call (kernel 5 once per RAFT
# iteration with low_memory, kernels 1 and 2 once per tracker call).
@pytest.mark.parametrize("mode", ["accuracy", "anytime", "speed",
                                  "speed_sidecar", "split"])
def test_raft_script_mode_on_card_matches_cpu(card, mode):
    from feature_tracker_tpu_torch.scripts import raft_bf16_eval

    before = lookup_correlation_cuda.launches
    small = dict(h=64, w=128, iterations=2, iters=1, rounds=1)
    if mode in ("accuracy", "anytime"):
        fn = getattr(raft_bf16_eval, mode)
        got, want = (fn(n_batches=1, device=d) for d in (card, "cpu"))
        assert lookup_correlation_cuda.launches == before   # all-pairs
        if mode == "accuracy":
            got = got["raft_accuracy_64x64_compact_6it"]
            want = want["raft_accuracy_64x64_compact_6it"]
            assert abs(got["f32"]["epe"] - want["f32"]["epe"]) <= 1e-3
            assert abs(got["bf16"]["epe"] - got["f32"]["epe"]) <= 0.05
        else:
            got, want = got["raft_anytime"], want["raft_anytime"]
            for key in ("epe_k6", "epe_k12", "zero_flow_epe"):
                assert abs(got[key] - want[key]) <= 1e-3, key
    elif mode == "speed":
        out = raft_bf16_eval.speed(device=card, **small)["raft_speed_128x64"]
        for name in ("f32", "bf16", "bf16_last_up"):
            assert out[name]["lookup_launches_per_call"] == {"1it": 1,
                                                             "2it": 2}
        assert out["clock"] == "cuda events" and out["card"] != "cpu"
    elif mode == "speed_sidecar":
        out = raft_bf16_eval.speed_sidecar(device=card, **small)["raft_speed"]
        assert [out[k]["lookup_launches_per_call"] for k in (
            "shipped_k2", "shipped_k1", "parity_f32_k2")] == [2, 1, 2]
    else:
        got, want = (raft_bf16_eval.split(device=d, **small)[
            "raft_iteration_split"] for d in (card, "cpu"))
        assert got["lookup_launches_per_loop"] == 2
        assert want["lookup_launches_per_loop"] == 0
        assert got["lookup_checksum"] == pytest.approx(
            want["lookup_checksum"], rel=1e-6)


@pytest.mark.parametrize("mode", ["fast", "direct", "inverse", "multipair"])
def test_klt_script_on_card_matches_cpu(card, mode):
    from feature_tracker_tpu_torch.scripts import klt_multipair, time_klt_modes

    if mode == "multipair":
        kw = dict(inner=2, iters=1, rounds=1)
        got = klt_multipair.run(2, 160, 256, 512, device=card, **kw)
        want = klt_multipair.run(2, 160, 256, 512, device="cpu", **kw)
        assert (got["composite_launches"], got["sequential_launches"]) == (
            1, 2)
        assert got["status_mismatch_composite_vs_sequential_interior"] == 0
        assert got["max_pos_diff_composite_vs_sequential_interior_px"] <= 0.2
        assert 0 <= got["status_mismatch_vs_cpu"] <= want[
            "status_mismatch_vs_cpu"] + 2
        assert abs(got["tracked_composite"] - want["tracked_composite"]) <= 1
        return
    n = 1024
    got, want = (time_klt_modes.run(mode, n=n, iters=1, rounds=1, device=d)
                 for d in (card, "cpu"))
    assert got["launches_per_call"] == 1 and want["launches_per_call"] == 0
    assert abs(got["tracked"] - want["tracked"]) <= 1
