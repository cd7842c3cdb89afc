"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
built from source at first use and have no CPU mode); without them the
tests skip. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.ops import cuda_klt
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.trackers.klt import BasicKlt
from feature_tracker_tpu_torch.trackers.klt.basic import (
    track_pyramid_fast_reference,
)

from synthetic import translated_pair

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


@pytest.mark.parametrize("opts", [KltOptions(),
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
