"""The port's CoTracker2 (``models/cotracker2.py``) against the plain float32
reference (``benchmark/reference/cotracker2.py``) on the CPU, at a small size
(hidden 32, 2 heads, 2 + 2 layers, 8 virtual tracks, 64x64 frames, 16
tracks, 12 frames) with the reference's seeded weights; and kernel 5's
border mode in its plain twin (``raft.lookup_correlation_otf``) against
the reference's all-pairs volume sampled by ``grid_sample``."""

import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.models import raft
from feature_tracker_tpu_torch.models.cotracker2 import (
    CoTracker2,
    CoTracker2Config,
    CoTracker2Online,
    token_dim,
    track_layout,
)
from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
    lookup_correlation_cuda,
    staged_share,
)
from chip_smoke import cotracker2_reference

ref = cotracker2_reference()

SMALL = dict(model_resolution=[64, 64], stride=4, latent_dim=128,
             hidden_size=32, num_heads=2, time_depth=2, space_depth=2,
             mlp_ratio=4.0, num_virtual_tracks=8, window_len=8,
             corr_levels=4, corr_radius=3, input_dim=456, iterations=4)
FRAMES, TRACKS = 12, 16

# Both sides compute in float32 and differ only in the order of sums (the
# lookup's on-the-fly dot products against the sampled all-pairs volume,
# the fused attention against the written-out softmax, the convolutions'
# blocking): 2e-5 to 1.5e-4 px and logits to 1.1e-4 within a window from
# the same inputs (four seeds, three cases). The
# flow embedding's frequencies (up to 968 rad a pixel) amplify a gap ~10x
# from one window to the next, to 3.2e-3 px and logits 7.4e-3 by the third
# window (three seeds, three cases). So a window run from the port's own
# carried state (online) is held to 1e-3, a whole clip of three chained
# windows to 2e-2 px and 3e-2; a wrong mask, transpose or carried state
# moves tracks by 0.1-3 px here.
WINDOW_TOL = 1e-3
CLIP_TOL_PX, CLIP_TOL_LOGIT = 2e-2, 3e-2


def port_config(cfg, **kw):
    return CoTracker2Config(**dict(cfg, model_resolution=tuple(
        cfg["model_resolution"]), **kw))


@pytest.fixture(scope="module")
def models():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    weights = ref.draw_weights(SMALL, 5, "cpu")
    model = CoTracker2(port_config(SMALL), device="cpu")
    model.load_state_dict(weights)
    yield model, ref.CoTracker2Reference(weights, SMALL, "cpu")
    torch.set_num_threads(threads)


def clip(seed):
    """A smooth random 12-frame RGB clip drifting right by 1 px a frame."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.uniform(0, 255, (1, 3, 24, 40)).astype(
        np.float32))
    big = torch.nn.functional.interpolate(base, (64, 96), mode="bilinear",
                                          align_corners=False)[0]
    return np.stack([big[:, :, 16 - t:80 - t].permute(1, 2, 0).round().to(
        torch.uint8).numpy() for t in range(FRAMES)])


def queries(case, seed):
    rng = np.random.default_rng(seed)
    t = np.zeros(TRACKS)
    x = rng.uniform(4, 60, TRACKS)
    y = rng.uniform(4, 60, TRACKS)
    if case == "later_queries":          # the masks act
        t = rng.integers(0, FRAMES - 2, TRACKS).astype(np.float64)
        t[:4] = [0, 5, 8, 10]
    if case == "leave_frame":            # the border clamp acts
        x[:8] = [-12.0, -3.0, 0.0, 63.0, 66.0, 75.0, 30.0, 20.0]
        y[:8] = [10.0, 70.0, -9.0, 63.0, 30.0, 80.0, -20.0, 64.5]
    return np.stack([t, x, y], -1)


def reference_state(st):
    """The port's carried state (``OnlineState``) as the reference's."""
    return {"queries": st.queries, "frames": st.frames, "start": st.start,
            "coords": st.coords, "vis": st.vis, "track_feat": st.track_feat}


@pytest.mark.parametrize("case", ["offline", "online", "later_queries",
                                  "leave_frame"])
def test_port_matches_the_reference(models, case):
    """Offline cases: the whole clip, each side carrying its own state.
    Online cases: every window from the port's carried state, on both
    sides (the benchmark's check); "later_queries" online, where the masks
    and the sampling of the query features on later frames act;
    "leave_frame", with queries outside and on the frame's edge, where the
    border clamp acts."""
    model, reference = models
    video, q = clip(1), queries(case, 2)
    if case in ("online", "later_queries"):
        online = CoTracker2Online(model)
        assert online.step(video[:4], q) is None
        state = reference.online_start(q, video[:4])
        for key, value in reference_state(online.state).items():
            assert torch.equal(torch.as_tensor(value), torch.as_tensor(
                state[key])) if value is not None else state[key] is None
        pairs = []
        for k in range(4, FRAMES, 4):
            want, _ = reference.online_step(reference_state(online.state),
                                            video[k:k + 4])
            pairs.append((online.step(video[k:k + 4]), want))
            assert online.state.start == k
        tol_px = tol_logit = WINDOW_TOL
    else:
        pairs = [(model(video, q), reference.offline(video, q))]
        tol_px, tol_logit = CLIP_TOL_PX, CLIP_TOL_LOGIT
    moved = 0.0
    for (tracks, vis), (want_tracks, want_vis) in pairs:
        assert tracks.shape == want_tracks.shape
        assert vis.shape == want_vis.shape == tracks.shape[:2]
        gap = torch.linalg.vector_norm(tracks - want_tracks, dim=-1).max()
        assert float(gap) < tol_px, float(gap)
        assert float((vis - want_vis).abs().max()) < tol_logit
        moved = max(moved, float((tracks[-1] - torch.as_tensor(
            q[:, 1:], dtype=torch.float32)).abs().max()))
    assert moved > 0.1                   # the tracks did move


def test_online_windows_are_the_offline_windows(models):
    """Online, a window carries what the offline loop carries: 16 frames
    give the same tracks either way (offline, a frame keeps the last window
    over it: the window at ``k - 4`` gives frames ``k - 4 .. k - 1``), but
    for the convolutions' blocking at another batch, amplified from window
    to window."""
    model, _ = models
    video = np.concatenate([clip(3), clip(4)[:4]])
    q = queries("later_queries", 5)
    tracks, vis = model(video, q)
    online = CoTracker2Online(model)
    online.step(video[:4], q)
    for k in range(4, 16, 4):
        got_tracks, got_vis = online.step(video[k:k + 4])
        assert (got_tracks[:4] - tracks[k - 4:k]).abs().max() < CLIP_TOL_PX
        assert (got_vis[:4] - vis[k - 4:k]).abs().max() < CLIP_TOL_LOGIT
    assert (got_tracks[4:] - tracks[12:]).abs().max() < CLIP_TOL_PX


def test_weights_load_at_the_published_widths():
    """The reference's names and shapes are the port's, key for key, at the
    published configuration, whose token has the published 456 channels."""
    cfg = dict(SMALL, model_resolution=[384, 512], hidden_size=384,
               num_heads=8, time_depth=6, space_depth=6,
               num_virtual_tracks=64)
    shapes = ref.weight_shapes(cfg)
    model = CoTracker2(port_config(cfg), device="cpu")
    state = model.state_dict()
    assert token_dim(model.cfg) == 456
    assert set(state) == set(shapes)
    assert all(tuple(state[k].shape) == shapes[k][0] for k in shapes)
    assert model.pos_emb.shape == (96, 128, 456)
    with pytest.raises(ValueError, match="input_dim"):
        CoTracker2(port_config(SMALL, input_dim=455), device="cpu")


def test_track_layout():
    assert track_layout(2500) == (50, 50)
    assert track_layout(16) == (4, 4)
    assert track_layout(12) == (3, 4)
    assert track_layout(7) == (1, 7)


def _lookup_inputs(seed, b=2, n=(6, 5), c=12, hw=(20, 28), levels=3):
    rng = np.random.default_rng(seed)
    f0 = torch.from_numpy(rng.normal(0, 1, (b, *n, c)).astype(np.float32))
    f1 = torch.from_numpy(rng.normal(0, 1, (b, *hw, c)).astype(np.float32))
    locs = rng.uniform(-12, max(hw) + 12, (b, *n, 2)).astype(np.float32)
    locs[0, 0, :2] = [[-40.0, 5.0], [2e9, -3e9]]    # far outside: clamped
    return f0, raft.pool_feature_pyramid(f1, levels), torch.from_numpy(locs)


@pytest.mark.parametrize("radius", [3, 1])
def test_border_lookup_matches_volume_and_grid_sample(radius):
    """Border mode equals the release's route: each level's all-pairs
    volume sampled by ``grid_sample(border, align_corners=True)``, whose
    samples are x-major. The two differ in the order of the sum over
    channels and in ``grid_sample``'s rescaled coordinates: ~1e-6."""
    f0, pyr, locs = _lookup_inputs(7)
    b, h, w, c = f0.shape
    got = raft.lookup_correlation_otf(f0, pyr, locs, radius, "border")
    sampler = ref.CoTracker2Reference({}, dict(SMALL, corr_radius=radius),
                                      "cpu")
    want = sampler.corr_sample([p.permute(0, 3, 1, 2) for p in pyr],
                               f0.reshape(b, h * w, c),
                               locs.reshape(b, h * w, 2))
    k = 2 * radius + 1
    want = want.reshape(b, h, w, len(pyr), k, k).transpose(-1, -2)
    assert torch.allclose(got, want.reshape(got.shape), atol=2e-5,
                          rtol=1e-5)
    zeros = raft.lookup_correlation_otf(f0, pyr, locs, radius)
    assert not torch.allclose(got, zeros, atol=1e-3)  # the clamp acted
    nan_locs = locs.clone()
    nan_locs[1, 2, 3] = float("nan")
    nan_out = raft.lookup_correlation_otf(f0, pyr, nan_locs, radius,
                                          "border")
    assert (nan_out[1, 2, 3] == 0).all()


def test_zeros_mode_is_the_default_bit_for_bit():
    """``padding="zeros"`` is RAFT's lookup, unchanged: on the CPU the
    wrapper's plain route and the plain twin return the same bits."""
    f0, pyr, locs = _lookup_inputs(8)
    want = raft.lookup_correlation_otf(f0, pyr, locs, 3)
    assert torch.equal(raft.lookup_correlation_otf(f0, pyr, locs, 3,
                                                   "zeros"), want)
    assert torch.equal(lookup_correlation_cuda(f0, pyr, locs, 3, "zeros"),
                       want)
    with pytest.raises(ValueError, match="padding"):
        raft.lookup_correlation_otf(f0, pyr, locs, 3, "reflect")
    with pytest.raises(ValueError, match="padding"):
        lookup_correlation_cuda(f0, pyr, locs, 3, "reflect")


def test_staged_share_in_border_mode():
    """In border mode a query far off the map has its centre clamped next
    to the map, so its tile still stages; in zeros mode it has no work."""
    locs = torch.zeros(1, 8, 8, 2)
    locs[..., 0] = torch.arange(8.0)[None, :] - 500.0
    locs[..., 1] = torch.arange(8.0)[:, None]
    shapes = [(24, 32), (12, 16)]
    border = staged_share(locs, shapes, 3, 128, "border")
    zeros = staged_share(locs, shapes, 3, 128)
    assert border["tiles"] == zeros["tiles"] == 1.0
    assert zeros["staged_pixels"] == 0
    assert border["staged_pixels"] > 0

