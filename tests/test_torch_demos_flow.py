"""The port's RAFT and CoTracker demos against the JAX demos, on the CPU.

The reference side replays the JAX demo's calls with the JAX package, its
module constants read from the demo file by AST (tests/test_torch_demos.py
says why no JAX demo module is imported).

Tolerances:
  - RAFT's shape check: the per-iteration prediction shapes equal JAX's
    (the weights are drawn from seeds on both sides, by different
    generators, so only shapes can match); the trained compact model's EPE
    on the demo's synthetic pair within 1e-4 px of JAX's, in float32;
  - CoTracker, by tests/test_torch_cotracker.py's rule: the flow
    embedding's frequencies reach 2^47 at width 192, so a whole run is
    held to JAX within the larger of 1e-3 px (tracks) / 1e-4 (visibility
    logits) and twice JAX's own spread under a one-ulp change of the
    video; the queries (Harris on frame 0 of the crop) equal;
  - the chained basic KLT: statuses by the 0.1 % / at least 1 rule, uv of
    features tracked on both sides within 1e-3 px;
  - the synthetic clip (``synthetic_video`` from seed 7) bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.utils.weights import weights_path
from test_torch_demos import (
    TRACKED,
    UV_TOL,
    assert_statuses,
    assert_tracked_uv,
    assert_writes_only,
    jax_constants,
    synthetic_inputs,
)

EPE_TOL = 1e-4
TRACKS_TOL, VIS_TOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while a module of these runs: the
    suite runs several test files at once on the CPU, and more threads per
    file only wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_raft_demo_matches_jax():
    from feature_tracker_tpu.models.raft import Raft, RaftConfig
    from feature_tracker_tpu.train.raft_pretrain import synthetic_flow_sample
    from feature_tracker_tpu.utils.weights import load_pytree
    from feature_tracker_tpu_torch.demos import raft_demo

    ref, cur, sample = raft_demo.inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        ref, np.asarray(jnp.asarray(rng.uniform(0, 255, (5, 64, 64, 1)),
                                    jnp.float32)))
    np.testing.assert_array_equal(
        cur, np.asarray(jnp.asarray(rng.uniform(0, 255, (5, 64, 64, 1)),
                                    jnp.float32)))
    rimg, cimg, gt = synthetic_flow_sample(np.random.default_rng(77), 64,
                                           64, augment=False)
    for got, want in zip(sample, (rimg, cimg, gt)):
        np.testing.assert_array_equal(got, want)

    got = raft_demo.run(ref, cur, sample, iters=1, device="cpu")
    model = Raft(RaftConfig(max_iterations=5))
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), ref, cur)
    flows = jax.eval_shape(model.apply, variables, ref, cur)
    assert got["shapes"] == [tuple(flows.shape[1:])] * flows.shape[0] \
        == [(5, 64, 64, 2)] * 5

    tcfg = RaftConfig(max_iterations=6, feature_channels=64,
                      context_channels=64, hidden_channels=32,
                      correlation_pyramid_levels=2, correlation_radius=3,
                      correlation_hidden_channels=32,
                      correlation_out_channels=16,
                      flow_hidden_channels=16, flow_out_channels=8,
                      motion_out_channels=16, mask_hidden_channels=32)
    tmodel = Raft(tcfg)
    like_img = jnp.zeros((1, 64, 64, 1), jnp.float32)
    like = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(tmodel.init, jax.random.PRNGKey(0), like_img,
                       like_img))
    trained = load_pytree(weights_path("raft_small.npz"),
                          {"params": like["params"],
                           "batch_stats": like.get("batch_stats", {})})
    preds = jax.jit(tmodel.apply)(trained, jnp.asarray(rimg)[None, ..., None],
                                  jnp.asarray(cimg)[None, ..., None])
    epe = float(jnp.mean(jnp.linalg.norm(preds[-1][0] - jnp.asarray(gt),
                                         axis=-1)))
    assert abs(got["epe"] - epe) <= EPE_TOL, (got["epe"], epe)
    assert got["zero_epe"] == float(np.linalg.norm(gt, axis=-1).mean())
    assert got["epe"] < 0.5 * got["zero_epe"]
    assert np.abs(got["flow"] - np.asarray(preds[-1][0])).max() <= 1e-3


def jax_cotracker(video, clip):
    """demos/cotracker_demo.py's calls: the model's tracks (before the
    doubling) and visibility logits on the crop, with JAX's spread under
    a one-ulp change of the video, the same on the synthetic clip, the
    queries and the chained KLT."""
    from feature_tracker_tpu.core.config import HarrisOptions, KltOptions
    from feature_tracker_tpu.models.cotracker import (
        CoTracker,
        CoTrackerConfig,
    )
    from feature_tracker_tpu.ops.detect import detect_good_features
    from feature_tracker_tpu.ops.pyramid import build_pyramid
    from feature_tracker_tpu.trackers.klt import BasicKlt
    from feature_tracker_tpu.utils.weights import load_pytree

    c = jax_constants("cotracker_demo")
    with open(weights_path("metrics.json")) as f:
        mcfg = json.load(f).get("cotracker", {}).get("config", {})
    cfg = CoTrackerConfig(
        feature_dim=mcfg.get("feature_dim", 64),
        model_dim=mcfg.get("model_dim", 128),
        depth=mcfg.get("depth", 2),
        iterations=mcfg.get("iterations", 4),
        time_encoding=mcfg.get("time_encoding", False))
    model = CoTracker(cfg)
    uv0, num = detect_good_features(
        jnp.asarray(video[0]), c["N_POINTS"],
        HarrisOptions(min_feature_distance=12, min_valid_response=20.0))
    uv0 = np.asarray(uv0)[:int(num)]
    crop = c["CROP"]
    small = video.reshape(-1, crop // 2, 2, crop // 2, 2).mean((2, 4))
    vid = small[..., None].astype(np.float32)
    queries = (uv0 * 0.5).astype(np.float32)
    like = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0), vid, queries))
    params = load_pytree(weights_path("cotracker.npz"), like["params"])
    apply = jax.jit(lambda v, q: model.apply({"params": params}, v, q))

    def with_spread(v, q):
        tracks, vis = (np.asarray(a) for a in apply(v, q))
        t2, v2 = apply(np.nextafter(v, np.float32(np.inf)), q)
        return tracks, vis, (np.abs(tracks - np.asarray(t2)).max(),
                             np.abs(vis - np.asarray(v2)).max())

    tracker = BasicKlt(KltOptions(max_track_points=c["N_POINTS"]))
    pyrs = [build_pyramid(jnp.asarray(f), c["LEVELS"]) for f in video]
    uv = jnp.asarray(uv0)
    status = jnp.full((uv0.shape[0],), 0, jnp.int8)
    klt = [np.asarray(uv)]
    for t in range(1, len(video)):
        uv, status = tracker.track(pyrs[t - 1], pyrs[t], uv, uv, status)
        klt.append(np.asarray(uv))
    svid, sq = (np.asarray(a, np.float32) for a in clip[:2])
    return {"uv0": uv0, "crop": with_spread(vid, queries),
            "klt": (np.stack(klt), np.asarray(status)),
            "synthetic": with_spread(svid, sq)}


def assert_run_close(got_tracks, got_vis, want):
    tracks, vis, spread = want
    assert got_tracks.shape == tracks.shape and got_vis.shape == vis.shape
    assert np.abs(got_tracks - tracks).max() <= max(TRACKS_TOL,
                                                    2 * spread[0])
    assert np.abs(got_vis - vis).max() <= max(VIS_TOL, 2 * spread[1])


def test_cotracker_demo_matches_jax(tmp_path):
    from feature_tracker_tpu.train.cotracker_pretrain import (
        synthetic_video,
    )
    from feature_tracker_tpu_torch.demos import cotracker_demo

    left, _, curs, source = synthetic_inputs()[1]
    video = cotracker_demo.load_video(left, curs)
    c = jax_constants("cotracker_demo")
    assert video.shape == (6, c["CROP"], c["CROP"])
    clip = cotracker_demo.synthetic_clip()
    want_clip = synthetic_video(np.random.default_rng(7), 8, 96, 96,
                                c["N_POINTS"], max_theta_step=0.05,
                                max_shift_step=4.0)
    for a, b in zip(clip, want_clip):
        np.testing.assert_array_equal(a, np.asarray(b))

    got = cotracker_demo.run(video, clip, source, device="cpu",
                             out_dir=str(tmp_path))
    want = jax_cotracker(video, clip)
    np.testing.assert_array_equal(got["uv0"], want["uv0"])
    assert len(got["uv0"]) == c["N_POINTS"]
    assert_run_close(got["tracks"] / 2.0, got["vis"], want["crop"])
    assert_run_close(got["synthetic"]["tracks"], got["synthetic"]["vis"],
                     want["synthetic"])
    klt_uv, klt_st = want["klt"]
    assert got["track_calls"] == len(video) - 1
    assert_statuses(got["klt_status"], klt_st)
    assert_tracked_uv(got["klt_tracks"][-1], got["klt_status"], klt_uv[-1],
                      klt_st, UV_TOL["basic"])
    ok = got["klt_status"] == TRACKED
    assert ok.sum() >= len(ok) // 2
    d = np.linalg.norm(got["tracks"][-1][ok] - got["klt_tracks"][-1][ok],
                       axis=-1)
    assert got["median_dev"] == float(np.median(d))
    assert got["synthetic"]["epe"] <= got["synthetic"]["zero_epe"] + 0.1
    assert_writes_only(tmp_path, got, ["cotracker_tracks.png",
                                       "cotracker_synthetic.png"])
