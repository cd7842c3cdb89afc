"""CPU parity of the port's front end with the JAX package, the state that
crosses between them, and the port's independence from JAX."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from feature_tracker_tpu.core import config as jax_config
from feature_tracker_tpu.pipeline import FrontEndConfig as JaxFrontEndConfig
from feature_tracker_tpu.pipeline import TrackingFrontEnd as JaxFrontEnd
from feature_tracker_tpu.trackers import klt as jax_klt
from feature_tracker_tpu_torch.convert import (
    front_end_state_from_jax,
    options_from_jax,
    tracker_from_jax,
)
from feature_tracker_tpu_torch.core import config
from feature_tracker_tpu_torch.pipeline import FrontEndConfig, TrackingFrontEnd

from synthetic import translated_pair

REPO = pathlib.Path(__file__).resolve().parent.parent


def _sequence(n_frames=5, h=120, w=160, dc=3.0):
    """Texture translating by dc px/frame in x."""
    base, _ = translated_pair(h=h, w=w + int(dc) * n_frames + 8,
                              shift=(0.0, 0.0))
    return [base[:, int(round(dc * i)):int(round(dc * i)) + w]
            for i in range(n_frames)]


def _jax_cfg(capacity, min_live, distance, response):
    return JaxFrontEndConfig(
        capacity=capacity, min_live_tracks=min_live,
        klt=jax_config.KltOptions(max_track_points=capacity),
        harris=jax_config.HarrisOptions(min_feature_distance=distance,
                                        min_valid_response=response))


def _assert_same_frame(j, t):
    assert t.frame_id == j.frame_id and t.num_live == j.num_live
    np.testing.assert_array_equal(t.track_ids, j.track_ids)
    np.testing.assert_array_equal(t.status, np.asarray(j.status))
    np.testing.assert_allclose(t.uv, j.uv, atol=1e-3)
    assert t.uv.dtype == np.float32 and t.status.dtype == np.int8


@pytest.mark.parametrize("capacity,min_live,distance,response",
                         [(128, 20, 10, 20.0), (64, 64, 8, 10.0)])
def test_front_end_matches_jax(capacity, min_live, distance, response):
    """Equal ids, statuses and live counts and uv within 1e-3 px over 5
    frames; the second case replenishes on every frame."""
    frames = _sequence()
    jcfg = _jax_cfg(capacity, min_live, distance, response)
    jfe = JaxFrontEnd(jcfg)
    tfe = TrackingFrontEnd(options_from_jax(jcfg), device="cpu")
    for f in frames:
        _assert_same_frame(jfe.process_frame(f), tfe.process_frame(f))
    assert tfe.process_frame(frames[-1]).num_live > 10


def _jax_tracker(kind, capacity):
    opts = jax_config.KltOptions(max_track_points=capacity)
    if kind == "affine":
        return jax_klt.AffineKlt(opts)
    if kind == "lssd-luminance":
        return jax_klt.LssdKlt(opts, consider_patch_luminance=True)
    if kind == "lssd":
        return jax_klt.LssdKlt(opts)
    return jax_klt.BasicKlt(dataclasses.replace(
        opts, method=jax_config.KltMethod(kind)))


@pytest.mark.parametrize("kind", ["inverse", "direct", "affine", "lssd",
                                  "lssd-luminance"])
def test_front_end_with_each_tracker_matches_jax(kind):
    """TrackingFrontEnd(cfg, tracker=...) with the trackers of this slice,
    each carried across by tracker_from_jax: equal ids, statuses and live
    counts over 4 frames. uv within 5e-3 px for the warp trackers (their
    ill-conditioned solve, see test_torch_warp_klt.py), 1e-3 otherwise."""
    frames = _sequence(n_frames=4, dc=2.0)
    jcfg = _jax_cfg(64, 20, 10, 20.0)
    jtracker = _jax_tracker(kind, 64)
    jfe = JaxFrontEnd(jcfg, tracker=jtracker)
    tfe = TrackingFrontEnd(options_from_jax(jcfg),
                           tracker=tracker_from_jax(jtracker, device="cpu"),
                           device="cpu")
    atol = 1e-3 if kind in ("inverse", "direct") else 5e-3
    for f in frames:
        j, t = jfe.process_frame(f), tfe.process_frame(f)
        assert t.frame_id == j.frame_id and t.num_live == j.num_live
        np.testing.assert_array_equal(t.track_ids, j.track_ids)
        np.testing.assert_array_equal(t.status, np.asarray(j.status))
        np.testing.assert_allclose(t.uv, j.uv, atol=atol)
    assert t.num_live > 10


def test_options_from_jax_round_trips_every_field():
    pairs = [
        (jax_config.KltOptions(max_track_points=7, max_iterations=9,
                               max_tolerance_large_step=2,
                               patch_row_half_size=4, patch_col_half_size=5,
                               max_converge_step=1e-3,
                               method=jax_config.KltMethod.INVERSE,
                               integer_pyramid=False), config.KltOptions),
        (jax_config.HarrisOptions(min_feature_distance=3,
                                  min_valid_response=1.5, max_candidates=99,
                                  window_half_size=2), config.HarrisOptions),
        (jax_config.PyramidOptions(levels=2, quantize=False),
         config.PyramidOptions),
        (_jax_cfg(32, 8, 6, 5.0), FrontEndConfig),
    ]
    for theirs, cls in pairs:
        ours = options_from_jax(theirs)
        assert type(ours) is cls
        names = [f.name for f in dataclasses.fields(cls)]
        assert names == [f.name for f in dataclasses.fields(theirs)]
        for name in names:
            a, b = getattr(theirs, name), getattr(ours, name)
            if dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a).keys() == \
                    dataclasses.asdict(b).keys()
            elif hasattr(a, "value"):
                assert a.value == b.value
            else:
                assert a == b, name
    # Defaults agree too.
    for jcls, cls in ((jax_config.KltOptions, config.KltOptions),
                      (jax_config.HarrisOptions, config.HarrisOptions),
                      (jax_config.PyramidOptions, config.PyramidOptions),
                      (JaxFrontEndConfig, FrontEndConfig)):
        assert options_from_jax(jcls()) == cls()


def test_load_state_dict_resumes_a_jax_front_end():
    frames = _sequence(n_frames=5)
    jcfg = _jax_cfg(96, 30, 10, 20.0)
    jfe = JaxFrontEnd(jcfg)
    for f in frames[:3]:
        jfe.process_frame(f)
    tfe = TrackingFrontEnd(options_from_jax(jcfg), device="cpu")
    tfe.load_state_dict(front_end_state_from_jax(jfe))
    for f in frames[3:]:
        _assert_same_frame(jfe.process_frame(f), tfe.process_frame(f))

    state = tfe.state_dict()
    again = TrackingFrontEnd(options_from_jax(jcfg), device="cpu")
    again.load_state_dict(state)
    assert again.state_dict()["next_id"] == state["next_id"]
    for a, b in zip(again.state_dict()["prev_pyramid"],
                    state["prev_pyramid"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        TrackingFrontEnd(FrontEndConfig(capacity=8),
                         device="cpu").load_state_dict(state)


def test_front_end_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrackingFrontEnd()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "feature_tracker_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    names = {str(p.relative_to(REPO / "feature_tracker_tpu_torch"))
             for p in files[:-1]}
    assert {"ops/interp.py", "ops/cuda_warp_klt.py", "trackers/klt/affine.py",
            "trackers/klt/lssd.py", "trackers/klt/multi.py",
            "convert.py"} <= names
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax",
                                "feature_tracker_tpu"), (path, mod)


# Names of the JAX package that a ported module may still lack, each with
# its reason. Everything else public in a JAX module must be in its
# counterpart.
ALLOWED_MISSING = {
    "train/__init__.py": set(),
    "train/pretrain.py": set(),
}
PORT = REPO / "feature_tracker_tpu_torch"
JAX_PACKAGE = REPO / "feature_tracker_tpu"
COUNTERPARTS = sorted(
    str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
    if (JAX_PACKAGE / p.relative_to(PORT)).exists())


def _public_names(path):
    """(functions, classes and upper-case constants defined at the top
    level and not starting with ``_``; the ``__all__`` list or None), read
    from the source without importing it."""
    names, exported = set(), None
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    exported = list(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name) and t.id.isupper():
                    names.add(t.id)
    return {n for n in names if not n.startswith("_")}, exported


@pytest.mark.parametrize("module", COUNTERPARTS)
def test_ported_module_has_the_jax_public_names(module):
    """Each port module carries the public names of its JAX counterpart
    (more is fine), and a package's ``__all__`` is JAX's, in JAX's order,
    but for the allowed names above."""
    allowed = ALLOWED_MISSING.get(module, set())
    jax_names, jax_all = _public_names(JAX_PACKAGE / module)
    names, exported = _public_names(PORT / module)
    assert sorted(jax_names - names - allowed) == []
    if jax_all is not None:
        assert (exported or []) == [n for n in jax_all if n not in allowed]


def test_the_name_guard_covers_the_ported_modules():
    assert {"ops/__init__.py", "ops/window.py", "models/__init__.py",
            "train/raft_eval.py", "utils/weights.py", "train/__init__.py",
            "trackers/klt/basic.py", "pipeline.py",
            "match/__init__.py", "match/brief.py", "match/matcher.py",
            "core/geometry.py", "trackers/direct.py", "trackers/dense.py",
            "runtime/__init__.py", "runtime/native.py", "runtime/stream.py",
            "runtime/cpu_baseline.py", "utils/__init__.py", "utils/log.py",
            "utils/timer.py", "utils/profiling.py",
            "utils/viz.py", "models/superpoint.py", "models/disk.py",
            "models/lightglue.py", "match/nn_matcher.py",
            "models/cotracker.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharded.py", "parallel/ba.py", "parallel/window_ba.py",
            "parallel/scaling.py", "train/checkpoint.py",
            "train/raft_train.py", "train/raft_pretrain.py",
            "train/superpoint_train.py", "train/disk_train.py",
            "train/lightglue_train.py", "train/pretrain.py",
            "train/cotracker_pretrain.py"} \
        <= set(COUNTERPARTS)
    assert set(ALLOWED_MISSING) <= set(COUNTERPARTS)
