"""The port's CoTracker pretraining (``train/cotracker_pretrain.py``)
against the JAX package's, on the CPU.

The data functions give JAX's arrays bit for bit for the same seed:
synthetic videos, pools, and, with the same frames planted in both
packages' real-image pools, the KLT-verified real-video tracks and their
samples. Three steps of the train step from JAX's ``model.init`` state
give JAX's losses within 1e-5 relative, the first step's Adam moments by
the rules of tests/test_torch_train_models.py, the parameters after three
steps within 1e-6 where the gradient is well above rounding, and the
parameter average's movement within 1e-3 of its own size. ``main`` writes the JAX package's npz
layout and ``metrics.json`` keys into a temporary ``WEIGHTS_DIR`` and
leaves ``weights/`` as it was. tests/test_cotracker_train.py's cases run
on the port.
"""

import functools
import hashlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_tracker_tpu.models import cotracker as jcot
from feature_tracker_tpu.train import cotracker_pretrain as jcp
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu.utils.weights import load_pytree
from feature_tracker_tpu_torch.convert import (
    cotracker_train_state_from_jax,
    options_from_jax,
)
from feature_tracker_tpu_torch.models.cotracker import CoTracker
from feature_tracker_tpu_torch.train import cotracker_pretrain as pcp
from feature_tracker_tpu_torch.train import optim as poptim
from feature_tracker_tpu_torch.train import pretrain as ppre
from synthetic import Texture

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = jcot.CoTrackerConfig(feature_dim=32, model_dim=32, depth=1,
                             iterations=2)
T, H, W, N, B = 4, 32, 32, 6, 2


def weights_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "weights").iterdir())}


def planted_frames():
    """Six 120x176 frames of a texture moving (1.3, -0.7) px a frame: the
    stand-in for the real sequence."""
    tex = Texture(3, n_waves=16, min_period=5.0, max_period=30.0)
    return [tex.render(120, 176, warp=lambda x, y, k=k: (
        x - 1.3 * k, y + 0.7 * k)) for k in range(6)]


@pytest.fixture
def planted(monkeypatch):
    """The same frames in both packages' real-image pools, and both
    real-track caches empty, for the duration of a test."""
    frames = planted_frames()
    monkeypatch.setattr(jpre, "_REAL_POOL", [f.copy() for f in frames])
    monkeypatch.setattr(ppre, "_REAL_POOL", [f.copy() for f in frames])
    monkeypatch.setattr(jcp, "_REAL_TRACKS", None)
    monkeypatch.setattr(pcp, "_REAL_TRACKS", None)
    return frames


def assert_pools_equal(got, want):
    assert len(got) == len(want)
    for g_batch, w_batch in zip(got, want):
        for g, w in zip(g_batch, w_batch):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("augment", [True, False])
def test_synthetic_video_and_pool_are_jax_data(augment):
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        for j, p in zip(jcp.synthetic_video(a, 5, 24, 40, 7,
                                            augment=augment),
                        pcp.synthetic_video(b, 5, 24, 40, 7,
                                            augment=augment)):
            np.testing.assert_array_equal(p, j)
    assert_pools_equal(
        pcp.make_pool(np.random.default_rng(6), 2, 2, 4, 24, 32, 5,
                      augment=augment, wide_motion=True, device="cpu"),
        jcp.make_pool(np.random.default_rng(6), 2, 2, 4, 24, 32, 5,
                      augment=augment, wide_motion=True))


def test_np_pyramid_is_jax_data():
    img = np.random.default_rng(0).uniform(0, 255, (37, 50)).astype(
        np.float32)
    for g, w in zip(pcp._np_pyramid(img), jcp._np_pyramid(img)):
        np.testing.assert_array_equal(g, w)


def test_real_video_tracks_and_samples_are_jax_data(planted):
    frames, tracks = pcp._real_video_tracks()
    j_frames, j_tracks = jcp._real_video_tracks()
    assert j_tracks is not None and tracks is not None
    np.testing.assert_array_equal(frames, j_frames)
    np.testing.assert_array_equal(tracks, j_tracks)
    a, b = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(2):
        for j, p in zip(jcp.real_video_sample(a, 8, 32, 40, 5),
                        pcp.real_video_sample(b, 8, 32, 40, 5)):
            np.testing.assert_array_equal(p, j)
    assert_pools_equal(
        pcp.make_pool(np.random.default_rng(3), 2, 2, 4, 32, 32, 5,
                      real_frac=0.5, device="cpu"),
        jcp.make_pool(np.random.default_rng(3), 2, 2, 4, 32, 32, 5,
                      real_frac=0.5))


def test_real_video_without_frames_is_none(monkeypatch):
    monkeypatch.setattr(ppre, "_REAL_POOL", [])
    monkeypatch.setattr(pcp, "_REAL_TRACKS", None)
    assert pcp._real_video_tracks() == (None, None)
    assert pcp.real_video_sample(np.random.default_rng(0), 4, 32, 32,
                                 4) is None


# ------------------------------------- tests/test_cotracker_train.py's
def _sample(img, x, y):
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0
    return ((1 - fy) * (1 - fx) * img[y0, x0]
            + (1 - fy) * fx * img[y0, x0 + 1]
            + fy * (1 - fx) * img[y0 + 1, x0]
            + fy * fx * img[y0 + 1, x0 + 1])


def test_shapes_and_visibility():
    rng = np.random.default_rng(0)
    video, queries, tracks, vis = pcp.synthetic_video(rng, 5, 48, 64, 7,
                                                      augment=False)
    assert video.shape == (5, 48, 64, 1)
    assert queries.shape == (7, 2)
    assert tracks.shape == (5, 7, 2)
    assert vis.shape == (5, 7)
    np.testing.assert_allclose(tracks[0], queries)
    assert (vis[0] == 1.0).all()
    inside = ((tracks[..., 0] >= 0) & (tracks[..., 0] <= 63)
              & (tracks[..., 1] >= 0) & (tracks[..., 1] <= 47))
    np.testing.assert_array_equal(vis.astype(bool), inside)


def test_tracks_follow_image_content():
    rng = np.random.default_rng(1)
    video, queries, tracks, vis = pcp.synthetic_video(rng, 6, 64, 64, 16,
                                                      augment=False)
    checked = 0
    for k in range(1, 6):
        for i in range(16):
            x, y = tracks[k, i]
            if not (2 <= x < 61 and 2 <= y < 61):
                continue
            got = _sample(video[k, :, :, 0], x, y)
            want = _sample(video[0, :, :, 0], *queries[i])
            assert abs(got - want) < 3.0, (k, i, got, want)
            checked += 1
    assert checked > 20


def test_trajectory_is_smooth():
    rng = np.random.default_rng(2)
    _, _, tracks, _ = pcp.synthetic_video(rng, 8, 96, 96, 8, augment=False)
    step = np.linalg.norm(np.diff(tracks, axis=0), axis=-1)
    assert step.max() < 15.0


def test_real_video_tracks_and_samples(planted):
    """tests/test_cotracker_train.py's real-video case on the planted
    frames (the real sequence is not in the repository), where the motion
    is known: (1.3, -0.7) px a frame."""
    frames, tracks = pcp._real_video_tracks()
    assert frames is not None
    t, m = tracks.shape[:2]
    assert t == frames.shape[0] and m >= 64
    d = np.linalg.norm(np.diff(tracks, axis=0), axis=-1)
    assert 0.5 < np.median(d) < 30.0
    np.testing.assert_allclose(np.median(np.diff(tracks, axis=0), axis=1),
                               [[1.3, -0.7]] * 5, atol=0.05)

    rng = np.random.default_rng(0)
    s = pcp.real_video_sample(rng, 8, 32, 40, 16)
    assert s is not None
    video, queries, tr, vis = s
    assert video.shape == (8, 32, 40, 1) and tr.shape == (8, 16, 2)
    assert queries.shape == (16, 2) and vis.shape == (8, 16)
    np.testing.assert_allclose(tr[0], queries, atol=1e-5)
    assert np.isfinite(video).all() and np.isfinite(tr).all()
    inside = ((tr[..., 0] >= 0) & (tr[..., 0] <= 39)
              & (tr[..., 1] >= 0) & (tr[..., 1] <= 31))
    np.testing.assert_array_equal(vis.astype(bool), inside)


# ------------------------------------------------------------------ step
def test_sigmoid_binary_cross_entropy_is_optax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 4, 200).astype(np.float32)
    z = (rng.uniform(size=200) < 0.5).astype(np.float32)
    want = np.asarray(optax.sigmoid_binary_cross_entropy(jnp.asarray(x),
                                                          jnp.asarray(z)))
    got = pcp._sigmoid_binary_cross_entropy(torch.tensor(x),
                                            torch.tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("peak,warmup,steps,init,end", [
    (5e-5, 50, 300, 0.0, 1e-6),      # cotracker_pretrain.main's defaults
    (1e-4, 500, 3000, 0.0, 1e-6),    # the shipped run's (metrics.json)
    (3e-4, 7, 20, 0.0, 0.0),         # the defaults of the keywords
    (1e-3, 3, 10, 1e-5, 2e-4)])
def test_warmup_cosine_schedule_is_optax(peak, warmup, steps, init, end):
    """optax's schedule at every count from 0 to steps + 2. XLA's cosine
    and torch's differ by up to one float32 ulp, which the tail of the
    decay, where the value nears end_value, shows relative to it: the
    limit is 1e-6 relative plus one ulp of the cosine (2^-23) times the
    peak."""
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, steps, end)
    got = poptim.warmup_cosine_schedule(peak, warmup, steps,
                                        init_value=init, end_value=end)
    counts = range(steps + 3)
    g = [float(got(torch.tensor(c, dtype=torch.int32))) for c in counts]
    w = [float(want(jnp.int32(c))) for c in counts]
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=peak * 2.0 ** -23)
    assert g[0] == w[0]          # the first step's rate, bit for bit


def jax_step_and_state(steps=3):
    model = jcot.CoTracker(SMALL)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((T, H, W, 1)),
                                 jnp.zeros((N, 2)))["params"]
    # The heads start at zero (Flax's init): perturb them so that the
    # first step's gradients reach every leaf.
    rng = np.random.default_rng(9)
    upd = dict(params["update"])
    for head in ("delta_head", "vis_head"):
        upd[head] = {k: jnp.asarray(rng.normal(0, 0.05, v.shape),
                                    jnp.float32)
                     for k, v in upd[head].items()}
    params = {**params, "update": upd}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, steps, 1e-6)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    return model, params, tx, sched


def test_train_steps_match_jax():
    model, params, tx, sched = jax_step_and_state()
    jstep = jcp.make_train_step(model, tx)
    jopt = tx.init(params)
    pmodel = CoTracker(options_from_jax(SMALL), device="cpu")
    ptx = poptim.ClipAdamW(poptim.warmup_cosine_schedule(
        1e-3, 1, 3, init_value=0.0, end_value=1e-6), weight_decay=1e-4)
    pstep = pcp.make_train_step(pmodel, ptx)
    pp, pe, po = cotracker_train_state_from_jax(params, params, jopt,
                                                device="cpu")
    pool = jcp.make_pool(np.random.default_rng(4), 3, B, T, H, W, N,
                         wide_motion=True)
    p0 = {k: v.clone() for k, v in pp.items()}
    jp, je, jo = params, params, jopt
    jl, pl, steps = [], [], []
    for batch in pool:
        jp, je, jo, jloss, jepe = jstep(jp, je, jo, *batch)
        pp, pe, po, ploss, pepe = pstep(pp, pe, po,
                                        *(np.asarray(a) for a in batch))
        jl += [float(jloss), float(jepe)]
        pl += [float(ploss), float(pepe)]
        steps.append((pp, po, cotracker_train_state_from_jax(
            jp, je, jo, device="cpu")))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    # The first step: lr 0 at count 0, so the parameters stay.
    got_p, got_o, (want_p, _, want_o) = steps[0]
    assert list(got_p) == list(want_p)
    assert int(got_o["count"]) == int(want_o["count"]) == 1
    for k, w in want_p.items():
        np.testing.assert_array_equal(got_p[k].numpy(), w.numpy())
    # After three steps. Every step's moments by the same rules. Adam
    # divides each first moment by the root of the second, so a gradient
    # element that is small in its leaf turns a rounding-sized difference
    # of the moments into a large one of its update: each parameter is
    # held to the difference of the two updates that the two sides'
    # moments give, times the step's rate, summed over the steps, plus two
    # float32 roundings a step; those bounds are a small part of the
    # movement where the gradient counts, so a wrong rate, decay or bias
    # correction fails. The parameter average moves by ~80 float32 ulps of
    # a weight in three steps; it is held to what the parameters'
    # differences feed into it (0.001 of them a step) plus two float32
    # roundings of the average a step (JAX may fuse the update).
    p_lim = {k: torch.zeros_like(v, dtype=torch.float64)
             for k, v in p0.items()}
    e_lim = dict.fromkeys(p0, 0.0)
    for got_p, got_o, (want_p, want_e, want_o) in steps:
        c = int(want_o["count"])
        lr = float(sched(c - 1))
        for moment in ("mu", "nu"):
            top = max(float(v.abs().max()) for v in want_o[moment].values())
            for k, w in want_o[moment].items():
                d = float((got_o[moment][k] - w).abs().max())
                assert d <= 1e-3 * float(w.abs().max()) + 1e-6 * top, (
                    c, moment, k)

        def update(o, k):
            m = o["mu"][k].double() / (1.0 - 0.9 ** c)
            v = o["nu"][k].double() / (1.0 - 0.999 ** c)
            return m / (v.sqrt() + 1e-8)

        for k in p0:
            ulps = 2.0 * torch.from_numpy(np.spacing(
                want_p[k].abs().numpy())).double()
            p_lim[k] += lr * (update(got_o, k) - update(want_o, k)).abs()
            p_lim[k] += ulps
            e_lim[k] += (0.001 * float((got_p[k] - want_p[k]).abs().max())
                         + 2.0 * float(np.spacing(np.float32(
                             want_e[k].abs().max()))))
    want_p, want_e, want_o = steps[-1][2]
    tight, ema = [], []
    for k, w in want_p.items():
        diff = (pp[k] - w).abs().double()
        assert bool((diff <= p_lim[k]).all()), k
        d = float((pe[k] - want_e[k]).abs().max())
        assert d <= e_lim[k], (k, d, e_lim[k])
        if k.endswith("weight") and "LayerNorm" not in k:
            # The limits are a small part of the movement: a scale at 1.0
            # moves by only ~17 of its ulps.
            ema.append(e_lim[k] / float((want_e[k] - p0[k]).abs().max()))
            tight.append(float((p_lim[k] <= 0.01 * (w - p0[k]).abs())
                               .double().mean()))
    assert max(ema) <= 0.15 and min(tight) > 0.75


def test_cotracker_forward_grad_keyword_keeps_inference():
    pmodel = CoTracker(options_from_jax(SMALL), device="cpu")
    pcp.init_params(pmodel, 0)
    video, queries, _, _ = pcp.synthetic_video(np.random.default_rng(0), T,
                                               H, W, N)
    a = pmodel(video, queries, return_all_iterations=True)
    b = pmodel(video, queries, return_all_iterations=True, grad=True)
    assert a[0].is_inference() and not b[0].is_inference()
    for x, y in zip(a, b):
        assert torch.equal(x, y.detach())


# ------------------------------------------------------------------ main
def test_main_writes_jax_layout(tmp_path, monkeypatch):
    before = weights_digest()
    kw = dict(steps=2, t=T, h=H, w=W, n_points=N, batch=B, eval_videos=2,
              pool_size=2, feature_dim=SMALL.feature_dim,
              model_dim=SMALL.model_dim, depth=SMALL.depth,
              iterations=SMALL.iterations, log_every=1)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jcp, "WEIGHTS_DIR", str(jdir))
    monkeypatch.setattr(pcp, "WEIGHTS_DIR", str(pdir))
    want = jcp.main(**kw)
    got = pcp.main(**kw, device="cpu")
    assert list(got) == list(want)
    # The held-out videos are data: the zero-motion baseline is JAX's.
    assert got["zero_motion_epe"] == want["zero_motion_epe"]
    assert sorted(p.name for p in pdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir()) == ["cotracker.npz", "metrics.json"]
    import json
    assert (list(json.loads((pdir / "metrics.json").read_text()))
            == list(json.loads((jdir / "metrics.json").read_text())))
    like = jcot.CoTracker(SMALL).init(jax.random.PRNGKey(0),
                                      jnp.zeros((T, H, W, 1)),
                                      jnp.zeros((N, 2)))
    loaded = load_pytree(str(pdir / "cotracker.npz"),
                         {"params": like["params"]})
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure({"params": like["params"]})
    # And JAX's model runs on it as on its own file.
    apply = functools.partial(jcot.CoTracker(SMALL).apply, loaded)
    video, queries, _, _ = jcp.synthetic_video(np.random.default_rng(1), T,
                                               H, W, N)
    assert np.isfinite(np.asarray(apply(video, queries)[0])).all()
    assert weights_digest() == before
