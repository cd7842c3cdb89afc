"""The port's pretraining driver (``train/pretrain.py``) against the JAX
package's, on the CPU.

The data functions give JAX's arrays bit for bit for the same seed: the
warps, the Harris and DISK labelers and the pools they fill (every
``numpy.random.Generator`` drawn in JAX's order), the cell labels and
correspondences, ``_fit_points``, ``_gt_assignment`` and the keypoints,
masks and ground truth of ``make_lightglue_sample`` (its descriptors, and
``_disk_teacher``'s targets, within float32 rounding: 1e-5). With the same
frames planted in both packages' real-image pools, the real-crop pairs of
``warped_texture_pair`` and ``raft_pretrain.make_real_pool`` are JAX's bit
for bit, and the pool's path is the JAX package's literal (read by AST).

tests/test_pretrain.py's cases run on the port (its counting cases in
tests/test_torch_pretrain_counts.py). The stages' steps are held to JAX's
in tests/test_torch_pretrain_steps.py, the stages in
tests/test_torch_pretrain_stages.py, ``_labels.py``, ``_matchers.py`` and
``_disk.py``, ``main`` in tests/test_torch_pretrain_main.py and
``_main_matchers.py``.
"""

import ast
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import disk as jdisk
from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu.train import raft_pretrain as jrp
from feature_tracker_tpu_torch.models.disk import DiskDetector
from feature_tracker_tpu_torch.models.superpoint import SuperPointDetector
from feature_tracker_tpu_torch.train import pretrain as ppre
from feature_tracker_tpu_torch.train import raft_pretrain as prp
from synthetic import Texture

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
SP = jsp.SuperPointConfig(descriptor_dim=32)
HW, BATCH = 32, 2


def planted_frames():
    """Six 160x200 frames of a texture moving (1.3, -0.7) px a frame: the
    stand-in for the real sequence."""
    tex = Texture(3, n_waves=16, min_period=5.0, max_period=30.0)
    return [tex.render(160, 200, warp=lambda x, y, k=k: (
        x - 1.3 * k, y + 0.7 * k)) for k in range(6)]


@pytest.fixture
def planted(monkeypatch):
    frames = planted_frames()
    monkeypatch.setattr(jpre, "_REAL_POOL", [f.copy() for f in frames])
    monkeypatch.setattr(ppre, "_REAL_POOL", [f.copy() for f in frames])
    return frames


@pytest.fixture(scope="module")
def detectors():
    """The shipped SuperPoint and DISK detectors on both sides."""
    return {"sp": (jsp.SuperPointDetector.from_file(max_features=32),
                   SuperPointDetector.from_file(max_features=32,
                                                device="cpu")),
            "disk": (jdisk.DiskDetector.from_file(max_features=32),
                     DiskDetector.from_file(max_features=32, device="cpu"))}


def assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------ the real-image pool
def _string_constants(path, function):
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    return [n.value for n in ast.walk(fn) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith("/")]


def test_real_image_paths_are_the_jax_packages():
    jax_file = REPO / "feature_tracker_tpu" / "train" / "pretrain.py"
    assert _string_constants(jax_file, "_real_image_pool") == [
        ppre.REFERENCE_FRAMES]
    assert _string_constants(jax_file, "_load_reference_pair") == [
        ppre.REFERENCE_PAIR + "/"]


def test_real_pool_pairs_are_jax_data(planted):
    assert len(ppre._real_image_pool()) == len(jpre._real_image_pool()) == 6
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for use_real in (None, None, None, None, True):
        ja, jb, jw = jpre.warped_texture_pair(a, 40, 48, use_real=use_real)
        pa, pb, pw = ppre.warped_texture_pair(b, 40, 48, use_real=use_real)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)
        pts = np.array([[3.0, 4.0], [30.5, 20.0]])
        np.testing.assert_array_equal(pw(pts), jw(pts))
    assert a.uniform() == b.uniform()
    want = jrp.make_real_pool(np.random.default_rng(1), 2, 32, 40, 2)
    got = prp.make_real_pool(np.random.default_rng(1), 2, 32, 40, 2,
                             device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_tuples_equal(g, w)


def test_real_pool_keeps_frames_loaded_before_a_failure(monkeypatch,
                                                        tmp_path):
    from PIL import Image
    Image.fromarray(np.full((8, 8), 7, np.uint8)).save(tmp_path / "left.png")
    (tmp_path / "000001.png").write_bytes(b"not a png")
    monkeypatch.setattr(ppre, "REFERENCE_FRAMES", str(tmp_path))
    monkeypatch.setattr(ppre, "_REAL_POOL", None)
    pool = ppre._real_image_pool()
    assert len(pool) == 1 and pool[0].shape == (8, 8)


def test_warped_pair_real_pool_when_available(planted):
    """tests/test_pretrain.py's case, on the planted frames."""
    rng = np.random.default_rng(1)
    a, b, warp = ppre.warped_texture_pair(rng, 64, 64, use_real=True)
    assert a.shape == (64, 64) and np.isfinite(a).all()
    assert 0.0 <= a.min() and a.max() <= 255.0


# ------------------------------------------------------------------ data
def test_warps_and_cells_are_jax_data():
    a, b = np.random.default_rng(2), np.random.default_rng(2)
    img = Texture(1).render(40, 56)
    for _ in range(3):
        jr, jt = jpre._random_similarity(a, 40, 56)
        pr, pt = ppre._random_similarity(b, 40, 56)
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(pt, jt)
        for g, w in zip(ppre._warp_image_np(img, pr, pt),
                        jpre._warp_image_np(img, jr, jt)):
            np.testing.assert_array_equal(g, w)
    _, _, warp = jpre.warped_texture_pair(a, 40, 56)
    for g, w in zip(ppre._cell_correspondence(warp, 5, 7),
                    jpre._cell_correspondence(warp, 5, 7)):
        np.testing.assert_array_equal(g, w)
    pts = [(3.2, 4.7), (55.4, 39.6), (20.5, 10.5), (-2.0, 3.0)]
    np.testing.assert_array_equal(ppre._cell_labels_from_points(pts, 40, 56),
                                  jpre._cell_labels_from_points(pts, 40, 56))
    for rng_seed in (None, 4):
        args = dict(cap=12)
        ja = jpre._fit_points(pts, warp, 40, 56, rng=None if rng_seed is None
                              else np.random.default_rng(rng_seed), **args)
        pa = ppre._fit_points(pts, warp, 40, 56, rng=None if rng_seed is None
                              else np.random.default_rng(rng_seed), **args)
        assert_tuples_equal(pa, ja)
    assert_tuples_equal(ppre._fit_points([], warp, 40, 56, cap=4),
                        jpre._fit_points([], warp, 40, 56, cap=4))


def test_harris_labels_are_jax_data():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        img, _, _ = jpre.warped_texture_pair(np.random.default_rng(5), 48, 48)
        want = jpre.harris_adaptation_points(img, a, 8, cap=48)
        got = ppre.harris_adaptation_points(img, b, 8, cap=48, device="cpu")
        assert got == want and len(got) > 3
    assert a.uniform() == b.uniform()


def test_disk_labels_are_jax_data(detectors):
    jdet, pdet = detectors["disk"]
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    img, _, _ = jpre.warped_texture_pair(np.random.default_rng(6), 48, 48)
    want = jpre.disk_adaptation_points(img, a, jdet, 8, cap=24)
    got = ppre.disk_adaptation_points(img, b, pdet, 8, cap=24)
    assert got == want and len(got) > 3
    assert a.uniform() == b.uniform()


def test_disk_teacher_targets(detectors):
    jdet, pdet = detectors["disk"]
    img = Texture(2).render(36, 44)          # padded to 40x48 by both
    uv = np.random.default_rng(0).uniform(2, 34, (10, 2)).astype(np.float32)
    want = jpre._disk_teacher(jdet)(img, uv)
    got = ppre._disk_teacher(pdet)(img, uv)
    assert got.shape == want.shape == (10, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_gt_assignment_unique_and_tolerant():
    """tests/test_pretrain.py's case on the port, and against JAX."""
    uv_ref = np.array([[10.0, 10.0], [20.0, 20.0], [30.0, 30.0]])
    warp = lambda p: p + np.array([1.0, 0.0])  # noqa: E731
    uv_cur = np.array([[11.0, 10.0], [21.2, 20.0], [90.0, 90.0]])
    gt = ppre._gt_assignment(uv_ref, uv_cur, warp, tol=2.0)
    assert gt[0] == 0 and gt[1] == 1 and gt[2] == -1
    uv_ref2 = np.array([[10.0, 10.0], [10.3, 10.0]])
    gt2 = ppre._gt_assignment(uv_ref2, np.array([[11.0, 10.0]]), warp,
                              tol=2.0)
    assert (gt2 >= 0).sum() == 1
    # Ties (equal distances) break as numpy's argsort and argmin do.
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 20, (40, 2)).astype(np.float64)
    cur = rng.integers(0, 20, (30, 2)).astype(np.float64)
    for r, c in ((ref, cur), (ref[:0], cur), (ref, cur[:0])):
        np.testing.assert_array_equal(ppre._gt_assignment(r, c, warp),
                                      jpre._gt_assignment(r, c, warp))


@pytest.mark.parametrize("kind", ["sp", "disk"])
def test_lightglue_sample_is_jax_data(detectors, kind):
    jdet, pdet = detectors[kind]
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for n_kpts in (12, 48):
        want = jpre.make_lightglue_sample(jdet, a, 48, 48, n_kpts)
        got = ppre.make_lightglue_sample(pdet, b, 48, 48, n_kpts)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            if i in (1, 4):          # descriptors
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(g, w)
        assert int(np.asarray(want[-1] >= 0).sum()) > 0


def jitted(model):
    """A stand-in for a Flax model whose ``apply`` is compiled once (the
    eager LightGlue apply is slower than its compile)."""
    return types.SimpleNamespace(apply=jax.jit(model.apply))


def test_stages_take_the_device():
    """The stages that make a model take ``device`` (the card by
    default); the others run on the device of the model or detector they
    are given."""
    import inspect
    for fn in (ppre.train_superpoint, ppre.train_disk, ppre.main,
               ppre.harris_adaptation_points):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ppre.train_disk(steps=1)
