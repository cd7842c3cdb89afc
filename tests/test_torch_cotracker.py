"""CPU parity of the port's CoTracker with the JAX package.

The same numpy inputs go through the Flax model and the port on the CPU.
Seeded weights (a 2-block model, feature width 16, model width 32) are
initialised by Flax under ``jax.jit``, every bias and LayerNorm scale and
the zero-initialised ``delta_head`` / ``vis_head`` perturbed with numpy
(else no track would move), and carried over by
``cotracker_state_from_jax``; the shipped ``weights/cotracker.npz`` goes to
both sides through their own loaders, at the configuration recorded in
``weights/metrics.json``.

The flow embedding's top frequencies are 2^47 (model width 192): from the
second iteration on, a last-bit difference of a flow becomes a different
angle in its high channels, so two implementations that round one product
differently drift apart over the iterations. JAX itself, given the same
video with every pixel moved by one ulp, moves its tracks by 1.19e-3 px
and its visibility logits by 1.0e-3 after four iterations (shipped
weights, the clip below). So each iteration is held from the same
positions (JAX's positions after the iteration before, through
``CoTracker.refine_step``), and the whole run against JAX's own spread.

Tolerances, and what was observed on the CPU when they were set:
  - one iteration from JAX's positions: tracks within 1e-3 px (observed
    3.8e-6 px), visibility logits within 1e-4 (observed 1.2e-9);
  - the whole run: within the larger of those and twice JAX's own spread
    under a one-ulp change of the video (observed 1.11e-3 px and 7.5e-4
    against a spread of 1.19e-3 px and 1.0e-3);
  - the frame encoder (``padding="SAME"`` at stride 2, odd and even
    sizes): 1e-5; correlation features: 1e-5; flow embedding: 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import cotracker as jct
from feature_tracker_tpu.utils import weights as jax_weights
from feature_tracker_tpu_torch.convert import (
    cotracker_state_from_jax,
    options_from_jax,
)
from feature_tracker_tpu_torch.models import cotracker as ct
from feature_tracker_tpu_torch.utils.weights import (
    load_cotracker_npz,
    shipped_cotracker_config,
    weights_path,
)
from synthetic import Texture

SMALL = jct.CoTrackerConfig(feature_dim=16, model_dim=32, num_heads=2,
                            depth=2, iterations=3)
STEP_TRACKS, STEP_VIS = 1e-3, 1e-4


def _perturbed(variables, seed):
    """Flax variables as numpy: biases and LayerNorm scales non-trivial,
    and the zero-initialised heads' kernels drawn, so that tracks move."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if path[-2].key in ("delta_head", "vis_head"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _clip(t, h, w, n, seed):
    """A texture moving (0.7, -0.4) px per frame, and n queries on frame 0,
    four of them near the border."""
    tex = Texture(seed)
    video = np.stack([tex.render(h, w, warp=lambda x, y, t=t: (
        x - 0.7 * t, y + 0.4 * t)) for t in range(t)])[..., None]
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, [w - 1, h - 1], (n, 2))
    q[:4] = [[0.5, 1.0], [w - 1.5, 2.0], [1.0, h - 1.0], [w - 1.0, h - 1.5]]
    return video.astype(np.float32), q.astype(np.float32)


def _run_jax(model, variables, video, queries):
    """(tracks, vis, per-iteration tracks) of the JAX model, and its own
    spread: the largest change of tracks and of vis when every pixel of
    the video moves by one ulp."""
    run = jax.jit(lambda v, q: model.apply(variables, v, q,
                                           return_all_iterations=True))
    tracks, vis, iters = (np.asarray(a) for a in run(video, queries))
    moved = np.nextafter(video, np.float32(np.inf)).astype(np.float32)
    tracks2, vis2, _ = run(moved, queries)
    spread = (np.abs(tracks - np.asarray(tracks2)).max(),
              np.abs(vis - np.asarray(vis2)).max())
    return tracks, vis, iters, spread


def _hold(port, video, queries, want):
    """The port against the JAX outputs ``want``: each iteration from
    JAX's positions, then the whole run."""
    tracks, vis, iters, spread = want
    t, n = tracks.shape[:2]
    start = np.broadcast_to(queries[None], (t, n, 2)).copy()
    for k in range(len(iters)):
        got, got_vis = port.refine_step(video, queries, start)
        np.testing.assert_allclose(got.numpy(), iters[k], rtol=0,
                                   atol=STEP_TRACKS)
        start = np.array(iters[k])
    np.testing.assert_allclose(got_vis.numpy(), vis, rtol=0, atol=STEP_VIS)
    got, got_vis, got_iters = port(video, queries, return_all_iterations=True)
    assert got.shape == (t, n, 2) and got_iters.shape == iters.shape
    assert np.abs(got.numpy() - tracks).max() <= max(STEP_TRACKS,
                                                     2 * spread[0])
    assert np.abs(got_vis.numpy() - vis).max() <= max(STEP_VIS,
                                                      2 * spread[1])
    assert torch.equal(got, got_iters[-1])


@pytest.fixture(scope="module", params=[False, True],
                ids=["no time encoding", "time encoding"])
def seeded(request):
    jcfg = dataclasses.replace(SMALL, time_encoding=request.param)
    model = jct.CoTracker(jcfg)
    video, queries = _clip(5, 31, 46, 12, 1)
    variables = _perturbed(jax.jit(model.init)(jax.random.PRNGKey(0), video,
                                               queries), 2)
    port = ct.CoTracker(options_from_jax(jcfg), device="cpu")
    port.load_state_dict(cotracker_state_from_jax(variables))
    return model, variables, port, video, queries


def test_seeded_cotracker_matches_jax(seeded):
    model, variables, port, video, queries = seeded
    want = _run_jax(model, variables, video, queries)
    # The perturbed heads move the tracks.
    assert np.abs(want[0] - queries[None]).max() > 1.0
    _hold(port, video, queries, want)


@pytest.mark.parametrize("shape", [(31, 46), (32, 47)])
def test_frame_encoder_matches_jax(seeded, shape):
    _, variables, port, _, _ = seeded
    frames = np.stack([Texture(s).render(*shape) for s in (8, 9)])[..., None]
    frames = (frames / 127.5 - 1.0).astype(np.float32)
    want = jct.FrameEncoder(SMALL.feature_dim).apply(
        {"params": variables["params"]["FrameEncoder_0"]}, frames)
    with torch.no_grad():
        got = port.FrameEncoder_0(torch.from_numpy(frames))
    h, w = shape
    assert got.shape == want.shape == (2, -(-h // 4), -(-w // 4), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_corr_features_and_flow_embedding_match_jax():
    rng = np.random.default_rng(7)
    fmaps = rng.normal(0, 1, (3, 9, 11, 8)).astype(np.float32)
    feat = rng.normal(0, 1, (5, 8)).astype(np.float32)
    # Windows inside, across the border and off the map.
    pos = rng.uniform(-4, 14, (3, 5, 2)).astype(np.float32)
    jpyr = [jnp.asarray(fmaps), jnp.asarray(fmaps[:, :8:2, :10:2] * 0.5)]
    want = jct._corr_features(jnp.asarray(feat), jpyr, jnp.asarray(pos), 2)
    got = ct._corr_features(torch.from_numpy(feat),
                            [torch.from_numpy(np.array(p)) for p in jpyr],
                            torch.from_numpy(pos), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    flow = rng.normal(0, 3, (4, 6, 2)).astype(np.float32)
    want = jct._flow_embedding(jnp.asarray(flow), 192)
    got = ct._flow_embedding(torch.from_numpy(flow), 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def shipped():
    """Both models on the shipped weights and the JAX outputs on 8 frames
    of 96x96 with 24 queries (the training shape in metrics.json)."""
    with open(weights_path("metrics.json")) as fh:
        recorded = json.load(fh)["cotracker"]
    jcfg = jct.CoTrackerConfig(**recorded["config"])
    assert options_from_jax(jcfg) == shipped_cotracker_config()
    model = jct.CoTracker(jcfg)
    video, queries = _clip(recorded["frames"], 96, 96, recorded["points"], 0)
    like = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0), video, queries))
    variables = jax_weights.load_pytree(weights_path("cotracker.npz"), like)
    port = ct.CoTracker(shipped_cotracker_config(), device="cpu")
    port.load_state_dict(load_cotracker_npz(weights_path("cotracker.npz")))
    return port, video, queries, _run_jax(model, variables, video, queries)


def test_shipped_cotracker_matches_jax(shipped):
    port, video, queries, want = shipped
    assert video.shape == (8, 96, 96, 1) and queries.shape == (24, 2)
    _hold(port, video, queries, want)


def test_cotracker_entry_points():
    port = ct.CoTracker(options_from_jax(SMALL), device="cpu")
    # The heads start at zero: an untrained tracker stays on its queries.
    video, queries = _clip(3, 20, 24, 5, 2)
    tracks, vis = port(video, queries)
    assert torch.equal(tracks, torch.from_numpy(queries)[None].expand(3, 5,
                                                                      2))
    assert torch.equal(vis, torch.zeros(3, 5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ct.CoTracker()
