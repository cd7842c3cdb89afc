"""Detection's suppression on the CPU (``ops/cuda_detect.py``): CPU tensors
take the plain greedy, and the rules kernel 6 follows on the card (its
conflict threshold, its grid of cells with four slots, its batches of 32
resolved in rank order, its early stop) give the sequential scan, on seeded
point sets with ties and pairs exactly the distance apart. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``). The file
imports no JAX."""

import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.ops import cuda_detect, detect
from feature_tracker_tpu_torch.utils import profiling

from synthetic import Texture, translated_pair
from torch_detect_cases import ring_points, tied_blobs


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _near(p, pts, threshold):
    """Whether integer point ``p`` lies closer than the threshold's root
    to any of ``pts`` ``[n, 2]``."""
    return bool((((pts - p) ** 2).sum(1) < threshold).any())


def sequential_scan(xy, threshold, max_num):
    """The specification: candidate i (rank order) is kept when no kept
    j < i has an integer squared distance below ``threshold``; the first
    ``max_num`` kept, as a list of ``(x, y)``."""
    kept = np.empty((len(xy), 2), np.int64)
    n = 0
    for p in np.asarray(xy, np.int64):
        if not _near(p, kept[:n], threshold):
            kept[n] = p
            n += 1
    return [tuple(int(v) for v in p) for p in kept[:min(n, max_num)]]


def kernel_scan(xy, shape, threshold, max_num):
    """Kernel 6's algorithm on the host: batches of 32 candidates, each
    tested against the points kept before the batch (the grid of
    ``grid_layout``, at most ``SLOTS`` a cell, or the list), then resolved
    in rank order among themselves; stops at ``max_num``. Returns the kept
    points, the grid's fullest cell and whether the grid was used."""
    layout = cuda_detect.grid_layout(shape, threshold)
    xy = np.asarray(xy, np.int64)
    kept = np.empty((len(xy), 2), np.int64)
    n, cells, fullest = 0, {}, 0
    for base in range(0, len(xy), 32):
        batch = xy[base:base + 32]
        alive = []
        for p in batch:
            if layout is None:
                near = kept[:n]
            else:
                cx, cy = p // layout[0]
                near = np.array([q for gx in (cx - 1, cx, cx + 1)
                                 for gy in (cy - 1, cy, cy + 1)
                                 for q in cells.get((gx, gy), [])],
                                np.int64).reshape(-1, 2)
            alive.append(not _near(p, near, threshold))
        taken = []
        for lane, p in enumerate(batch):
            earlier = [j for j in taken if _near(p, batch[j:j + 1],
                                                 threshold)]
            if alive[lane] and not earlier:
                taken.append(lane)
        for lane in taken[:max_num - n]:
            kept[n] = batch[lane]
            n += 1
            if layout is not None:
                slot = cells.setdefault(tuple(batch[lane] // layout[0]), [])
                slot.append(batch[lane])
                fullest = max(fullest, len(slot))
        if n == max_num:
            break
    return ([tuple(int(v) for v in p) for p in kept[:n]], fullest,
            layout is not None)


def _ranked_points(seed, n, shape, ties):
    """``n`` distinct pixels of an image of ``shape`` in rank order; with
    ``ties``, ranked as a stable sort ranks equal scores (by flat index)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    flat = rng.choice(h * w, size=n, replace=False)
    if ties:
        scores = rng.integers(0, 4, n)          # four score levels
        flat = flat[np.lexsort((flat, -scores))]
    return np.stack([flat % w, flat // w], axis=1)


@pytest.mark.parametrize("case", [
    # (seed, points, shape, min_feature_distance, max_num, ties, grid)
    (0, 4096, (480, 752), 25, 300, False, True),   # the front end's: early
    (1, 4096, (480, 752), 25, 10000, True, True),  # max_num above the kept
    (2, 3000, (120, 160), 10, 500, True, True),
    (3, 2000, (96, 128), 12, 40, False, True),
    (4, 4096, (480, 752), 6, 5000, True, True),    # the finest grid there
    (5, 1500, (480, 752), 5, 2000, False, False),  # the list path
    (6, 2500, (480, 752), 3, 2500, True, False),
    (7, 700, (60, 60), 4, 700, True, True),
    (8, 500, (48, 64), 0, 100, False, True),       # nothing conflicts
    (9, 800, (64, 64), 10.5, 800, True, True),     # a threshold of 111
    (10, 64, (480, 752), 25, 300, False, True),    # fewer than two batches
])
def test_kernel_rule_is_the_sequential_scan(case):
    seed, n, shape, distance, max_num, ties, grid = case
    xy = _ranked_points(seed, n, shape, ties)
    threshold = cuda_detect.conflict_threshold(distance)
    want = sequential_scan(xy, threshold, max_num)
    got, fullest, on_grid = kernel_scan(xy, shape, threshold, max_num)
    assert got == want and len(want) > 0
    assert fullest <= cuda_detect.SLOTS
    assert on_grid == grid


@pytest.mark.parametrize("max_num", [3, 300])
def test_kernel_rule_keeps_pairs_exactly_the_distance_apart(max_num):
    shape = (480, 752)
    xy = np.concatenate([ring_points((300, 200)), ring_points((700, 30)),
                         ring_points((30, 455))])
    threshold = cuda_detect.conflict_threshold(25)
    want = sequential_scan(xy, threshold, max_num)
    got, fullest, on_grid = kernel_scan(xy, shape, threshold, max_num)
    assert got == want and on_grid and fullest <= cuda_detect.SLOTS
    if max_num == 300:
        # The centre and the four axis points 25 px away: all kept.
        assert [tuple(p) for p in xy[:5]] == want[:5]
        assert (324, 200) not in want and (300, 176) not in want


@pytest.mark.parametrize("distance", [25, 12, 10, 3, 1, 0, -4, 0.5, 10.5,
                                      7.3, 2 ** 0.5, 1e-3, 100.000001])
def test_conflict_threshold_is_the_plain_float32_test(distance):
    """Integer squared distances below the threshold are those the plain
    version's float32 test calls a conflict."""
    d2 = torch.arange(0, 12000)
    plain = d2.to(torch.float32) < float(distance) ** 2
    threshold = cuda_detect.conflict_threshold(distance)
    assert torch.equal(d2 < threshold, plain)


def test_grid_layout():
    t = cuda_detect.conflict_threshold
    assert cuda_detect.grid_layout((480, 752), t(25)) == (25, 31, 20)
    assert cuda_detect.grid_layout((480, 752), t(6)) == (6, 126, 80)
    assert cuda_detect.grid_layout((480, 752), t(5)) is None
    assert cuda_detect.grid_layout((480, 752), t(0)) is None
    assert cuda_detect.grid_layout((48, 64), t(0)) == (1, 64, 48)
    assert cuda_detect.grid_layout((64, 64), t(10.5)) == (11, 6, 6)
    # A cell's side is the least whose square reaches the threshold.
    for threshold in range(1, 3000):
        cell = cuda_detect.grid_layout((1, 1), threshold)[0]
        assert cell ** 2 >= threshold > (cell - 1) ** 2


@pytest.mark.parametrize("case", ["translated_pair", "tied", "texture"])
def test_cpu_tensors_take_the_plain_greedy(case):
    """On CPU tensors detection runs the plain greedy inside the kernel's
    span: its rounds are counted and no kernel is, and the features are
    the sequential scan of the ranked candidates."""
    if case == "tied":
        img, opts, max_num = tied_blobs(), HarrisOptions(
            min_feature_distance=12, min_valid_response=10.0), 40
    elif case == "translated_pair":
        img, opts, max_num = translated_pair(h=120, w=160)[0], HarrisOptions(
            min_feature_distance=10, min_valid_response=20.0), 100
    else:
        img, opts, max_num = Texture(0, n_waves=16, min_period=5.0,
                                     max_period=30.0).render(120, 160), \
            HarrisOptions(min_feature_distance=8), 60
    before = cuda_detect.suppress_candidates_cuda.launches
    profiling.enable()
    uv, num = detect.detect_good_features(img, max_num, opts, device="cpu")
    snap = profiling.snapshot()
    assert snap.counter("detect.suppression_rounds") >= 1
    assert cuda_detect.COUNTER in snap.names
    assert snap.counter(cuda_detect.COUNTER) == 0
    assert cuda_detect.suppress_candidates_cuda.launches == before
    names = [snap.names[i] for i in snap.name]
    assert names[:2] == ["detect.features", "detect.suppress"]
    assert snap.parent[1] == 0
    scores, idx = detect.ranked_candidates(torch.from_numpy(img), opts)
    valid = idx[scores > -torch.inf].numpy()
    xy = np.stack([valid % img.shape[1], valid // img.shape[1]], axis=1)
    want = sequential_scan(xy, cuda_detect.conflict_threshold(
        opts.min_feature_distance), max_num)
    assert int(num) == len(want) > 5
    np.testing.assert_array_equal(uv[:len(want)].numpy(),
                                  np.array(want, np.float32))
    assert (uv[len(want):] == -1).all()
