"""The port's SuperPoint and LightGlue against the benchmark's plain
reference (``benchmark/reference/superpoint_lightglue.py``, loaded by path:
plain torch, no JAX, no module of the port), on the CPU at a small size, on
seeded weights and on the shipped ones; the ranking that detection and
SuperPoint share against the code each had before; and the path's spans and
counters.

Tolerances, and what was observed on the CPU when they were set:
  - heatmap: 1e-5 absolute (observed 9.3e-9 seeded, 6.4e-7 shipped); dense
    descriptors: 1e-4 of the map's largest magnitude (observed 7.4e-7):
    the convolutions sum in another order;
  - keypoints (uv and num): equal, the reference's selection on the port's
    own heatmap; keypoint descriptors: 1e-5 (observed 4.5e-8);
  - LightGlue's log-assignment over valid pairs: 1e-5 of its largest
    magnitude (observed 1.1e-4 at 61.7, 1.8e-6 of it, at depth 9 on the
    shipped weights); matchability logits: 1e-4 absolute (observed 6.7e-6):
    nine layers of float32 attention summed in another order; masked
    entries exactly -1e9.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feature_tracker_tpu_torch.convert import flax_variables_from_state
from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.match.nn_matcher import (
    NNFeatureMatcher,
    NNMatcherOptions,
)
from feature_tracker_tpu_torch.models import superpoint as sp
from feature_tracker_tpu_torch.models.layers import seeded_init
from feature_tracker_tpu_torch.models.lightglue import (
    LightGlue,
    LightGlueConfig,
)
from feature_tracker_tpu_torch.ops import detect
from feature_tracker_tpu_torch.utils import profiling
from feature_tracker_tpu_torch.utils.weights import weights_path
from synthetic import Texture
from torch_detect_cases import tied_blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
THRESHOLD = 0.0005


def _reference():
    path = os.path.join(ROOT, "benchmark", "reference",
                        "superpoint_lightglue.py")
    spec = importlib.util.spec_from_file_location("sp_lg_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _frame(seed, h=H, w=W):
    return np.clip(np.round(Texture(seed).render(h, w)), 0, 255).astype(
        np.uint8)


def _seeded_superpoint():
    """A port SuperPoint on weights drawn from a seed, its batch norms'
    statistics and affine parameters made non-trivial."""
    with seeded_init(3):
        model = sp.SuperPoint(device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        for name, t in model.named_parameters():
            if "BatchNorm" in name:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5
                        if name.endswith("weight")
                        else torch.randn(t.shape, generator=gen) * 0.1)
    return model.state_dict()


@pytest.fixture(scope="module", params=["seeded", "shipped"])
def superpoint(request):
    """``(port detector, reference variables)`` on the same weights."""
    if request.param == "shipped":
        det = sp.SuperPointDetector.from_file(device="cpu")
        variables = ref.load_variables(weights_path("superpoint.npz"))
    else:
        state = _seeded_superpoint()
        det = sp.SuperPointDetector(state, device="cpu")
        variables = flax_variables_from_state(state)
    det.min_response = THRESHOLD
    return det, variables


@pytest.fixture(scope="module", params=["seeded2", "shipped9"])
def lightglue(request):
    """``(port LightGlue, reference)`` on the same weights: drawn from a
    seed at depth 2, or the shipped file at depth 9."""
    if request.param == "shipped9":
        model = NNFeatureMatcher.from_file(device="cpu").model
        variables = ref.load_variables(
            weights_path("lightglue_superpoint.npz"))
    else:
        with seeded_init(5):
            model = LightGlue(LightGlueConfig(depth=2), device="cpu")
        variables = flax_variables_from_state(model.state_dict())
    return model, ref.LightGlueReference(variables, "cpu")


def test_superpoint_forward_matches_reference(superpoint):
    det, variables = superpoint
    frame = _frame(1)
    heat, desc = det.model(torch.from_numpy(frame).float()[None, :, :, None])
    want_heat, want_desc = ref.SuperPointReference(variables, "cpu").forward(
        frame)
    assert (heat[0] - want_heat).abs().max() <= 1e-5
    assert (desc[0] - want_desc).abs().max() <= 1e-4 * want_desc.abs().max()


@pytest.mark.parametrize("max_num", [64, 256])
def test_detect_matches_reference_selection(superpoint, max_num):
    det, variables = superpoint
    det.max_features = max_num
    frame = _frame(2)
    uv, desc, num = det.detect(frame)
    heat, dmap = det.model(torch.from_numpy(frame).float()[None, :, :, None])
    want_uv, want_num = ref.select_keypoints(heat[0], max_num, THRESHOLD, 4)
    assert int(num) == want_num > 10
    np.testing.assert_array_equal(uv.numpy(), want_uv)
    want_desc = ref.describe(dmap[0], uv)
    assert (desc - want_desc)[:want_num].abs().max() <= 1e-5


def _features(n, seed, masked):
    gen = torch.Generator().manual_seed(seed)
    uv = torch.rand((n, 2), generator=gen) * torch.tensor([W - 1.0, H - 1.0])
    desc = F.normalize(torch.randn((n, 256), generator=gen), dim=-1)
    mask = torch.ones(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=gen)[:masked]] = False
    return uv, desc, mask


@pytest.mark.parametrize("n,m,masked", [(64, 64, (0, 0)), (64, 48, (9, 5)),
                                        (256, 256, (40, 70))])
def test_lightglue_matches_reference(lightglue, n, m, masked):
    model, reference = lightglue
    uv0, d0, m0 = _features(n, 1, masked[0])
    uv1, d1, m1 = _features(m, 2, masked[1])
    scores, logit0, logit1 = model(uv0, d0, m0, uv1, d1, m1)
    want, want0, want1 = reference.forward(uv0, d0, m0, uv1, d1, m1)
    pair = m0[:, None] & m1[None, :]
    assert (scores - want)[pair].abs().max() <= 1e-5 * want[pair].abs().max()
    assert torch.equal(scores[~pair], want[~pair])
    assert (scores[~pair] == -1e9).all()
    assert (logit0 - want0)[m0].abs().max() <= 1e-4
    assert (logit1 - want1)[m1].abs().max() <= 1e-4


def test_matcher_keeps_the_reference_matches():
    """Frame to frame on the shipped weights, as the benchmark's cell: the
    matcher's status and matched positions are the reference's mutual
    best matches at the release's filter (ln 0.1)."""
    det = sp.SuperPointDetector.from_file(device="cpu", max_features=128,
                                          min_response=THRESHOLD)
    matcher = NNFeatureMatcher.from_file(
        NNMatcherOptions(max_number_of_matches=128,
                         min_valid_match_score=math.log(0.1)), device="cpu")
    variables = ref.load_variables(weights_path("lightglue_superpoint.npz"))
    big = _frame(3, H + 8, W + 8)
    feats = []
    for dy, dx in ((0, 0), (3, 5)):
        uv, desc, num = det.detect(big[dy:dy + H, dx:dx + W])
        feats.append((uv, desc, torch.arange(128) < num))
    (uv0, d0, m0), (uv1, d1, m1) = feats
    matched, status = matcher.match(d0, d1, uv0, uv1, m0, m1)
    scores = ref.LightGlueReference(variables, "cpu").forward(
        uv0, d0, m0, uv1, d1, m1)[0]
    idx = ref.mutual_matches(scores, 0.1)
    assert torch.equal(status.long() == 1, idx >= 0)
    found = idx >= 0
    assert int(found.sum()) > 20
    assert torch.equal(matched[found], uv1[idx[found]])


def _old_ranked_candidates(img, opts):
    """``ranked_candidates`` as it was before the ranking was shared: the
    oracle of the shared ranking."""
    dev = img.device
    h, w = img.shape
    resp = detect.shi_tomasi_response(img, opts.window_half_size)
    border = opts.window_half_size + 2
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    in_border = ((rows >= border) & (rows < h - border)
                 & (cols >= border) & (cols < w - border))
    local_max = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    cand = (resp >= local_max) & (resp > opts.min_valid_response) & in_border
    scores = torch.where(cand, resp, torch.full_like(resp, -torch.inf))
    k = min(opts.max_candidates, h * w)
    top_scores, flat_idx = torch.sort(scores.reshape(-1), descending=True,
                                      stable=True)
    return top_scores[:k], flat_idx[:k]


def _old_select_keypoints(heatmap, max_num, min_response, min_distance):
    """``select_keypoints`` as it was before it took the shared ranking and
    kernel 6's dispatch: the oracle of the CPU path."""
    dev = heatmap.device
    h, w = heatmap.shape
    local_max = F.max_pool2d(heatmap[None, None], 3, stride=1,
                             padding=1)[0, 0]
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    inb = ((rows >= 4) & (rows < h - 4) & (cols >= 4) & (cols < w - 4))
    cand = (heatmap >= local_max) & (heatmap > min_response) & inb
    scores = torch.where(cand, heatmap, torch.full_like(heatmap, -torch.inf))
    k = min(4096, h * w)
    top_scores, flat_idx = torch.sort(scores.reshape(-1), descending=True,
                                      stable=True)
    top_scores, flat_idx = top_scores[:k], flat_idx[:k]
    n_valid = int((top_scores > -torch.inf).sum())
    cy = (flat_idx[:n_valid] // w).to(torch.float32)
    cx = (flat_idx[:n_valid] % w).to(torch.float32)
    d2 = (cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2
    keep = detect.greedy_suppression(
        torch.ones(n_valid, dtype=torch.bool, device=dev),
        d2 < float(min_distance) ** 2)
    sel = torch.nonzero(keep).reshape(-1)[:max_num]
    uv = torch.full((max_num, 2), -1.0, dtype=torch.float32, device=dev)
    uv[:sel.shape[0], 0] = cx[sel]
    uv[:sel.shape[0], 1] = cy[sel]
    return uv, torch.tensor(sel.shape[0], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("name,opts", [
    ("texture", HarrisOptions()),
    ("texture", HarrisOptions(window_half_size=2, min_valid_response=5.0,
                              max_candidates=500)),
    ("tied", HarrisOptions(min_valid_response=10.0)),
    ("small", HarrisOptions(min_valid_response=0.0))])
def test_shared_ranking_is_the_old_ranked_candidates(name, opts):
    img = {"texture": lambda: Texture(0).render(120, 160),
           "tied": tied_blobs,
           "small": lambda: np.random.default_rng(6).uniform(
               0, 255, (20, 24))}[name]()
    t = torch.as_tensor(np.asarray(img, np.float32))
    got = detect.ranked_candidates(t, opts)
    want = _old_ranked_candidates(t, opts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("max_num,min_response,min_distance",
                         [(2048, THRESHOLD, 4), (50, 0.01, 8), (7, 0.9, 4)])
def test_select_keypoints_is_the_old_cpu_path(superpoint, max_num,
                                              min_response, min_distance):
    det, _ = superpoint
    frame = torch.from_numpy(_frame(4)).float()[None, :, :, None]
    heat = det.model(frame)[0][0]
    uv, num = sp.select_keypoints(heat, max_num, min_response, min_distance)
    want_uv, want_num = _old_select_keypoints(heat, max_num, min_response,
                                              min_distance)
    assert torch.equal(uv, want_uv) and torch.equal(num, want_num)


def test_path_spans_and_keypoint_counter():
    """One frame's spans nest as ``README.md`` lists them, and
    ``superpoint.keypoints`` is each detection's ``num``."""
    det = sp.SuperPointDetector.from_file(device="cpu", max_features=64,
                                          min_response=THRESHOLD)
    with seeded_init(7):
        matcher = NNFeatureMatcher(NNMatcherOptions(depth=2), device="cpu")
    matcher.initialize()
    profiling.enable()
    nums = []
    for seed in (5, 6):
        with profiling.span("frame"):
            uv, desc, num = det.detect(_frame(seed))
            mask = torch.arange(64) < num
            matcher.match(desc, desc, uv, uv, mask, mask)
        nums.append(int(num))
    snap = profiling.snapshot()
    names = [snap.names[i] for i in snap.name]
    parent = {name: names[snap.parent[k]] for k, name in enumerate(names)
              if snap.parent[k] >= 0}
    assert snap.calls == 2
    for child, up in (("superpoint.detect", "frame"),
                      ("superpoint.encode", "superpoint.detect"),
                      ("superpoint.select", "superpoint.detect"),
                      ("detect.suppress", "superpoint.select"),
                      ("superpoint.describe", "superpoint.detect"),
                      ("nn_matcher.match", "frame"),
                      ("lightglue.forward", "nn_matcher.match"),
                      ("lightglue.layer", "lightglue.forward"),
                      ("lightglue.assign", "lightglue.forward")):
        assert parent[child] == up
    assert names.count("lightglue.layer") == 2 * 2
    assert snap.counters["superpoint.keypoints"] == {0: nums[0], 1: nums[1]}
    assert min(nums) > 10
