"""The port's demo drivers (``feature_tracker_tpu_torch/demos/``) against
the JAX demos (``demos/*.py``), on the CPU: the classical demos, the
shared helpers, and the counterpart, device and isolation rules of every
demo (the neural ones are held in tests/test_torch_demos_models.py).

Each port demo's ``run`` gets the demo's own inputs, from the synthetic
loaders, at the demo's own size, with ``device="cpu"``. The reference side
replays the JAX demo's calls with the JAX package, its module constants
read from the demo file by AST. No JAX demo module is imported:
``demos/_common.py`` configures a JAX compile cache and its demos write
PNGs to the tracked ``demos/output/``; its three loaders are compiled here
from their source alone.

Tolerances:
  - statuses: at most 0.1 % differ, and at least 1 may (a sum reordered
    moves |v|^2 across the 4e-2 stop, ROADMAP.md "Hazards");
  - uv of features tracked on both sides: 1e-3 px for basic KLT, 5e-3 px
    for the affine and SE(2) trackers. Their 6x6 / 3x3 normal equations
    sit at float32's floor (ROADMAP.md §3), which JAX sums and solves in
    float32 and the port in float64: where JAX lies farther than 5e-3 px
    from the same plain tracker run in float64 (one feature of 300 in
    each, near the wrapped border, 0.013 px off), that run arbitrates, and
    the port is held to it within 5e-3 px at every feature;
  - BRIEF: detections, bits, matches and statuses exactly;
  - direct poses (q_rc, p_rc): 1e-5;
  - Farnebäck: interior statistics (tests/test_torch_dense.py: mean
    |d| <= 1e-3 px, 99th percentile <= 5e-3 px) on the interior pixels
    where JAX's flow follows the pair's true flow within 1 px (99 % of
    them); the other 1 % lie by the wrapped border, where the flow
    diverges and the chaos of the last bit (ROADMAP.md §3) grows to tens
    of px, so over the whole interior the 99th percentile is held to
    5e-3 px and the mean to the 0.05 px of tests/test_dense.py's native
    rule;
  - the SLAM demo's window BA: JAX's sharded-BA tolerances on poses and
    landmarks (tests/test_parallel.py), the rms history within 1e-4
    relative or twice JAX's own spread under a one-ulp change of the
    observations, as the launcher's BA (ROADMAP.md §3);
  - overlays, compared as arrays: a pixel may differ only within one
    disk radius of a feature whose status or rounded endpoint differs, or
    one pixel off the sampled line of a feature (a line sample that sits
    on a rounding boundary).
"""

import ast
import importlib
import inspect
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu_torch.demos import _common

REPO = Path(__file__).resolve().parent.parent
JAX_DEMOS = REPO / "demos"
PORT_DEMOS = REPO / "feature_tracker_tpu_torch" / "demos"
DEMOS = sorted(p.stem for p in JAX_DEMOS.glob("*_demo.py"))
NOT_TRACKED, TRACKED, OUTSIDE = 0, 1, 3
STATUS_SHARE = 1e-3
UV_TOL = {"basic": 1e-3, "affine": 5e-3, "lssd": 5e-3}
POSE_TOL = 1e-5
BA_RMS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while a module of these runs: the
    suite runs several test files at once on the CPU, and more threads per
    file only wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------ helpers
def jax_constants(demo):
    """The upper-case module constants of ``demos/<demo>.py``, by AST."""
    return module_constants(JAX_DEMOS / f"{demo}.py")


def module_constants(path):
    out = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            names = (target.elts if isinstance(target, ast.Tuple)
                     else [target])
            if not all(isinstance(n, ast.Name) and n.id.isupper()
                       for n in names):
                continue
            value = ast.literal_eval(node.value)
            values = value if isinstance(target, ast.Tuple) else [value]
            out.update({n.id: v for n, v in zip(names, values)})
    return out


def png_names(path):
    """The PNG file names a demo writes: every string literal ending in
    ``.png``, an f-string's fields as ``{}``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        elif isinstance(node, ast.JoinedStr):
            text = "".join(v.value if isinstance(v, ast.Constant) else "{}"
                           for v in node.values)
        else:
            continue
        names.update(re.findall(r"[\w{}]+\.png\b", text))
    return names


def jax_loaders():
    """``demos/_common.py``'s three loaders compiled from their source,
    without running the module (no compile cache, no output directory),
    reading a data root that does not exist."""
    tree = ast.parse((JAX_DEMOS / "_common.py").read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_synthetic_texture", "load_optical_flow_pair",
                           "load_direct_method_set")]
    assert len(keep) == 3
    ns = {"np": np, "os": os, "DATA_ROOT": str(REPO / "no-such-data")}
    exec(compile(ast.Module(keep, []), "demos/_common.py", "exec"), ns)
    return ns


def synthetic_inputs():
    """The port's loaders with no reference images present: the synthetic
    optical-flow pair and direct-method set."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_common, "DATA_ROOT", str(REPO / "no-such-data"))
        return (_common.load_optical_flow_pair(),
                _common.load_direct_method_set())


@pytest.fixture(scope="module")
def synthetic():
    return synthetic_inputs()


def assert_statuses(got, want):
    bad = int((np.asarray(got) != np.asarray(want)).sum())
    assert bad <= max(1, int(STATUS_SHARE * np.size(got))), bad


def assert_tracked_uv(got_uv, got_st, want_uv, want_st, tol):
    both = (np.asarray(got_st) == TRACKED) & (np.asarray(want_st) == TRACKED)
    assert both.sum() > 0
    d = np.abs(np.asarray(got_uv)[both] - np.asarray(want_uv)[both]).max()
    assert d <= tol, d


def _segment_pixels(a, b):
    """draw_lines' samples of the segment a -> b, both float (x, y)."""
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
    t = np.linspace(0.0, 1.0, n)[:, None]
    return np.round(a[None] * (1 - t) + b[None] * t).astype(np.int64)


def _stamp(mask, pts, r):
    h, w = mask.shape
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x = np.clip(pts[:, 0] + dx, 0, w - 1)
            y = np.clip(pts[:, 1] + dy, 0, h - 1)
            mask[y, x] = True


def assert_overlay_close(got, want, got_start, want_start, got_end,
                         want_end, got_st, want_st, radius=2, x_shift=0.0):
    """Two overlays of the same features (segments start -> end, drawn for
    tracked features, disks of ``radius`` at both ends) against the
    module docstring's rule; ``x_shift`` moves the ends (a side-by-side
    canvas)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    allowed = np.zeros(got.shape[:2], bool)
    shift = np.array([x_shift, 0.0], np.float32)
    for ga, wa, g, wt, gs, ws in zip(
            np.asarray(got_start, np.float32),
            np.asarray(want_start, np.float32),
            np.asarray(got_end, np.float32) + shift,
            np.asarray(want_end, np.float32) + shift,
            np.asarray(got_st), np.asarray(want_st)):
        if not np.isfinite(np.stack([ga, wa, g, wt])).all():
            continue
        moved = (gs != ws or (np.round(g) != np.round(wt)).any()
                 or (np.round(ga) != np.round(wa)).any())
        pts = np.concatenate([_segment_pixels(ga, g),
                              _segment_pixels(wa, wt)])
        _stamp(allowed, pts, radius + 1 if moved else 1)
    differs = (got != want).any(axis=-1)
    assert not (differs & ~allowed).any(), np.argwhere(differs & ~allowed)
    assert differs.mean() <= 1e-3, differs.mean()


def read_png(path):
    from PIL import Image
    return np.asarray(Image.open(path))


def assert_writes_only(tmp_path, out, names):
    """The demo wrote exactly its PNGs under ``tmp_path``, equal to the
    overlays it returned."""
    assert sorted(os.listdir(tmp_path)) == sorted(names)
    for name in names:
        np.testing.assert_array_equal(read_png(tmp_path / name),
                                      out["png"][name])


# ------------------------------------------------ counterparts, helpers
def test_synthetic_loaders_equal_the_jax_demos_bit_for_bit(synthetic):
    ns = jax_loaders()
    (ref, cur, source), (left, disp, curs, source2) = synthetic
    jref, jcur, jsource = ns["load_optical_flow_pair"]()
    jleft, jdisp, jcurs, jsource2 = ns["load_direct_method_set"]()
    assert (source, source2) == (jsource, jsource2) == ("synthetic",) * 2
    pairs = [(ref, jref), (cur, jcur), (left, jleft), (disp, jdisp)]
    pairs += list(zip(curs, jcurs))
    assert len(curs) == len(jcurs) == 5
    for got, want in pairs:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert ref.shape == (480, 752) and left.shape == (376, 1240)
    np.testing.assert_array_equal(cur, np.roll(np.roll(ref, 5, 0), -3, 1))
    np.testing.assert_array_equal(curs[2], np.roll(left, 6, 1))
    assert (disp == 64.0).all()


def test_every_jax_demo_is_covered():
    jax_mains = sorted(
        p.stem for p in JAX_DEMOS.glob("*.py")
        if any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in ast.parse(p.read_text()).body))
    assert jax_mains == DEMOS and len(DEMOS) == 11
    ported = sorted(p.stem for p in PORT_DEMOS.glob("*_demo.py"))
    assert ported == DEMOS


@pytest.mark.parametrize("demo", DEMOS)
def test_port_demo_keeps_the_jax_constants_and_png_names(demo):
    port = PORT_DEMOS / f"{demo}.py"
    assert module_constants(port) == jax_constants(demo)
    assert png_names(port) == png_names(JAX_DEMOS / f"{demo}.py")
    top = {n.name for n in ast.parse(port.read_text()).body
           if isinstance(n, ast.FunctionDef)}
    assert {"run", "main"} <= top


def test_run_sh_runs_every_demo_in_the_jax_order():
    jax_order = re.findall(r"python3 (\w+)\.py", (JAX_DEMOS / "run.sh")
                           .read_text())
    script = (PORT_DEMOS / "run.sh").read_text()
    port_order = re.findall(
        r"python3 -m feature_tracker_tpu_torch\.demos\.(\w+) \"\$@\"", script)
    assert port_order == jax_order and sorted(jax_order) == DEMOS
    assert "set -e" in script and os.access(PORT_DEMOS / "run.sh", os.X_OK)


def test_port_demos_import_no_jax():
    files = sorted(PORT_DEMOS.glob("*.py"))
    assert len(files) == 13
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                 "feature_tracker_tpu"), \
                    (path.name, mod)


@pytest.mark.parametrize("demo", DEMOS)
def test_demo_defaults_to_the_card(demo):
    """``run`` without a device raises here (no card) before it touches
    its inputs; nothing falls back to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    module = importlib.import_module(f"feature_tracker_tpu_torch.demos.{demo}")
    inputs = [p for p in inspect.signature(module.run).parameters.values()
              if p.default is p.empty and p.kind == p.POSITIONAL_OR_KEYWORD]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.run(*[None] * len(inputs))


def test_out_path_never_points_into_the_jax_output():
    assert Path(_common.OUT_DIR) == PORT_DEMOS / "output"
    assert "feature_tracker_tpu_torch/demos/output/" in (
        REPO / ".gitignore").read_text().splitlines()


# ------------------------------------------------------------ track_demo
def jax_track_demo(ref, cur):
    """demos/track_demo.py's calls (one track call per tracker)."""
    from feature_tracker_tpu.core.config import (
        HarrisOptions,
        KltMethod,
        KltOptions,
    )
    from feature_tracker_tpu.ops.detect import detect_good_features
    from feature_tracker_tpu.ops.pyramid import build_pyramid
    from feature_tracker_tpu.trackers.klt import AffineKlt, BasicKlt, LssdKlt
    from feature_tracker_tpu.utils.viz import render_tracked_features

    c = jax_constants("track_demo")
    uv, num = detect_good_features(
        jnp.asarray(ref), c["MAX_FEATURES"],
        HarrisOptions(min_feature_distance=25, min_valid_response=40.0))
    uv, num = np.asarray(uv), int(num)
    ref_pyr = build_pyramid(jnp.asarray(ref), c["PYRAMID_LEVELS"])
    cur_pyr = build_pyramid(jnp.asarray(cur), c["PYRAMID_LEVELS"])
    opts = KltOptions(max_track_points=c["MAX_FEATURES"],
                      patch_row_half_size=c["HALF_PATCH"],
                      patch_col_half_size=c["HALF_PATCH"],
                      method=KltMethod.FAST)
    out = {"num": num, "uv": uv[:num], "png": {}}
    for name, tracker in [("basic", BasicKlt(opts)),
                          ("affine", AffineKlt(opts)),
                          ("lssd", LssdKlt(opts))]:
        cur_uv, status = (np.asarray(a) for a in
                          tracker.track(ref_pyr, cur_pyr, uv[:num]))
        out[name] = {"uv": cur_uv, "status": status}
        out["png"][f"klt_{name}_tracking.png"] = render_tracked_features(
            cur, uv[:num], cur_uv, status)
    return out


def float64_warp_run(name, ref, cur, uv):
    """The port's plain affine or SE(2) tracker (FAST, the demo's options)
    with every input in float64: the arbiter of the warp trackers."""
    from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_pyramid_reference,
    )
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_pyramid_reference,
    )

    c = jax_constants("track_demo")
    opts = KltOptions(max_track_points=c["MAX_FEATURES"],
                      patch_row_half_size=c["HALF_PATCH"],
                      patch_col_half_size=c["HALF_PATCH"],
                      method=KltMethod.FAST)
    rp, cp = ([level.double() for level in
               build_pyramid(img, c["PYRAMID_LEVELS"], device="cpu")]
              for img in (ref, cur))
    uv = torch.from_numpy(uv).double()
    eye = torch.eye(2, dtype=torch.float64).expand(len(uv), 2, 2)
    skip = torch.zeros(len(uv), dtype=torch.bool)
    if name == "affine":
        out = affine_track_pyramid_reference(opts, rp, cp, uv, uv,
                                             eye.contiguous(), skip)
    else:
        out = lssd_track_pyramid_reference(opts, False, rp, cp, uv, uv,
                                           eye.contiguous(), skip)
    return out[0].numpy()


def test_track_demo_matches_jax(synthetic, tmp_path):
    from feature_tracker_tpu_torch.demos import track_demo

    ref, cur, source = synthetic[0]
    got = track_demo.run(ref, cur, source, iters=1, device="cpu",
                         out_dir=str(tmp_path))
    want = jax_track_demo(ref, cur)
    assert got["num"] == want["num"] == 300
    np.testing.assert_array_equal(got["uv"], want["uv"])
    assert got["track_calls"] == 2
    for name in ("basic", "affine", "lssd"):
        g, w = got[name], want[name]
        assert_statuses(g["status"], w["status"])
        tol = UV_TOL[name]
        if name == "basic":
            assert_tracked_uv(g["uv"], g["status"], w["uv"], w["status"],
                              tol)
        else:
            f64 = float64_warp_run(name, ref, cur, got["uv"])
            ok = (g["status"] == TRACKED) & (w["status"] == TRACKED)
            assert np.abs(g["uv"] - f64)[ok].max() <= tol
            far = ok & (np.abs(g["uv"] - w["uv"]).max(1) > tol)
            assert (np.abs(w["uv"] - f64)[far].max(1) > tol).all()
            assert far.sum() <= max(1, int(0.01 * got["num"])), far.sum()
        assert g["tracked"] == int((g["status"] == TRACKED).sum()) >= 290
        # The pair's true flow is (-3, +5) px away from the wrapped
        # border; the solver stops once a step is under 0.2 px.
        ok = g["status"] == TRACKED
        flow = np.median(g["uv"][ok] - got["uv"][ok], axis=0)
        np.testing.assert_allclose(flow, [-3.0, 5.0], atol=0.2)
        png = f"klt_{name}_tracking.png"
        assert_overlay_close(got["png"][png], want["png"][png], got["uv"],
                             want["uv"], g["uv"], w["uv"], g["status"],
                             w["status"])
    assert_writes_only(tmp_path, got, want["png"])


# ----------------------------------------------------------- stream_demo
def test_stream_demo_matches_jax(synthetic):
    """The frames that came through the port's ring, replayed through the
    JAX runtime's own convert + pyramid and JAX's tracker."""
    from feature_tracker_tpu.core.config import HarrisOptions, KltOptions
    from feature_tracker_tpu.ops.detect import detect_good_features
    from feature_tracker_tpu.runtime import get_runtime
    from feature_tracker_tpu.trackers.klt import BasicKlt
    from feature_tracker_tpu_torch.demos import stream_demo

    left, _, curs, source = synthetic[1]
    got = stream_demo.run(left, curs, source, device="cpu")
    frames = [np.clip(f, 0, 255).astype(np.uint8) for f in [left] + curs]
    assert got["frames"][0] == 0 and len(got["frames"]) + got["dropped"] == 6
    assert got["track_calls"] == len(got["frames"]) - 1 >= 1
    assert got["native"]

    c = jax_constants("stream_demo")
    rt = get_runtime()
    tracker = BasicKlt(KltOptions(max_track_points=c["MAX_FEATURES"]))
    pyrs = [tuple(jnp.asarray(level) for level in
                  rt.convert_and_pyramid(frames[i], c["LEVELS"]))
            for i in got["frames"]]
    uv, num = detect_good_features(pyrs[0][0], c["MAX_FEATURES"],
                                   HarrisOptions(min_feature_distance=25,
                                                 min_valid_response=40.0))
    assert got["num"] == int(num)
    status = jnp.where(jnp.arange(c["MAX_FEATURES"]) < num,
                       jnp.int8(NOT_TRACKED), jnp.int8(OUTSIDE))
    for k in range(1, len(pyrs)):
        uv, status = tracker.track(pyrs[k - 1], pyrs[k], uv, uv, status)
        g_uv, g_st = got["uv"][k - 1], got["status"][k - 1]
        assert_statuses(g_st, status)
        assert_tracked_uv(g_uv, g_st, uv, status, UV_TOL["basic"])
        assert got["tracked"][k - 1] == int((g_st == TRACKED).sum())
        status = jnp.where(status == TRACKED, jnp.int8(NOT_TRACKED), status)


# ------------------------------------------------------- direct method
def jax_direct_poses(left, disparity, curs, ref_uv, p_c_ref, levels):
    from feature_tracker_tpu.ops.pyramid import build_pyramid
    from feature_tracker_tpu.trackers.direct import DirectMethod

    c = jax_constants("direct_method_demo")
    ref_pyr = build_pyramid(jnp.asarray(left), levels)
    k4 = np.array([c["FX"], c["FY"], c["CX"], c["CY"]], np.float32)
    solver = DirectMethod()
    q_rc = p_rc = None
    out = []
    for cur in curs:
        cur_uv, q_rc, p_rc, status = solver.track(
            ref_pyr, build_pyramid(jnp.asarray(cur), levels), k4, p_c_ref,
            ref_uv, q_rc, p_rc)
        out.append(tuple(np.asarray(a) for a in (cur_uv, q_rc, p_rc,
                                                   status)))
    return out


def test_direct_method_demo_matches_jax(synthetic, tmp_path):
    from feature_tracker_tpu.utils.viz import render_tracked_features
    from feature_tracker_tpu_torch.demos import direct_method_demo

    left, disp, curs, source = synthetic[1]
    got = direct_method_demo.run(left, disp, curs, source, device="cpu",
                                 out_dir=str(tmp_path))
    c = jax_constants("direct_method_demo")
    h, w = left.shape
    rng = np.random.default_rng(0)
    ref_uv = np.stack([rng.integers(0, w, c["N_POINTS"]),
                       rng.integers(0, h, c["N_POINTS"])],
                      -1).astype(np.float32)
    depth = c["FX"] * c["BASELINE"] / np.maximum(
        disp[ref_uv[:, 1].astype(int), ref_uv[:, 0].astype(int)], 1.0)
    p_c_ref = np.stack([(ref_uv[:, 0] - c["CX"]) / c["FX"],
                        (ref_uv[:, 1] - c["CY"]) / c["FY"],
                        np.ones(c["N_POINTS"])], -1) * depth[:, None]
    want = jax_direct_poses(left, disp, curs, ref_uv, p_c_ref, c["LEVELS"])
    np.testing.assert_array_equal(got["ref_uv"], ref_uv)
    for k, (cur_uv, q, p, status) in enumerate(want):
        np.testing.assert_allclose(got["q_rc"][k], q, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(got["p_rc"][k], p, rtol=0, atol=POSE_TOL)
        # The synthetic frames are the left image moved by 2(k+1) px along
        # u at the depth of disparity 64: a pure translation of the camera
        # by -2(k+1) * BASELINE / 64 along x.
        np.testing.assert_allclose(
            got["p_rc"][k], [-2 * (k + 1) * c["BASELINE"] / 64.0, 0, 0],
            rtol=0, atol=1e-5)
        assert got["tracked"][k] == int((status == TRACKED).sum())
    assert_statuses(got["status"], status)
    assert_tracked_uv(got["cur_uv"], got["status"], cur_uv, status,
                      UV_TOL["basic"])
    want_png = render_tracked_features(curs[-1], ref_uv, cur_uv, status)
    name = "direct_method_tracking.png"
    assert_overlay_close(got["png"][name], want_png, ref_uv, ref_uv,
                         got["cur_uv"], cur_uv, got["status"], status)
    assert_writes_only(tmp_path, got, [name])


# ----------------------------------------------------------- dense flow
def test_dense_flow_demo_matches_jax(synthetic, tmp_path):
    from feature_tracker_tpu.ops.pyramid import build_pyramid
    from feature_tracker_tpu.trackers.dense import (
        DenseFlowOptions,
        DenseOpticalFlow,
    )
    from feature_tracker_tpu.utils.viz import render_dense_flow
    from feature_tracker_tpu_torch.demos import dense_flow_demo
    from test_torch_dense import MEAN_TOL, P99_TOL, _interior

    ref, cur, source = synthetic[0]
    got = dense_flow_demo.run(ref, cur, source, iters=1, device="cpu",
                              out_dir=str(tmp_path))
    want = np.asarray(DenseOpticalFlow(DenseFlowOptions(
        half_patch_size=2, max_iterations=20)).track(
            build_pyramid(jnp.asarray(ref), 5, quantize=False),
            build_pyramid(jnp.asarray(cur), 5, quantize=False)))
    assert got["flow"].shape == want.shape == (2, 480, 752)
    truth = np.array([5.0, -3.0])[:, None, None]       # (row, column) px
    follows = (np.abs(_interior(want) - truth) < 1.0).all(axis=0)
    assert follows.mean() >= 0.98
    d = np.abs(_interior(got["flow"]) - _interior(want))
    assert d[:, follows].mean() <= MEAN_TOL, d[:, follows].mean()
    assert np.percentile(d[:, follows], 99) <= P99_TOL
    assert np.percentile(d, 99) <= P99_TOL and d.mean() <= 0.05, d.mean()
    assert got["mean_abs"] == float(np.abs(got["flow"]).mean())
    assert abs(got["mean_abs"] - float(np.abs(want).mean())) <= 0.05
    # The grid the overlay samples: start points and flow vectors.
    rr, cc = np.meshgrid(np.arange(15, 480 - 15, 15),
                         np.arange(15, 752 - 15, 15), indexing="ij")
    start = np.stack([cc, rr], -1).reshape(-1, 2).astype(np.float32)

    def ends(flow):
        return start + np.stack([flow[1][rr, cc].reshape(-1),
                                 flow[0][rr, cc].reshape(-1)], -1)

    tracked = np.full(len(start), TRACKED)
    name = "dense_flow_vectors.png"
    assert_overlay_close(got["png"][name],
                         render_dense_flow(cur, want, step=15), start, start,
                         ends(got["flow"]), ends(want), tracked, tracked,
                         radius=1)
    assert_writes_only(tmp_path, got, [name])


# ---------------------------------------------------------- BRIEF match
def test_match_brief_demo_matches_jax_exactly(synthetic, tmp_path):
    from feature_tracker_tpu.core.config import HarrisOptions
    from feature_tracker_tpu.match.brief import compute_brief
    from feature_tracker_tpu.match.matcher import (
        fill_matched_pixels,
        hamming_distance_matrix,
        nearby_match,
    )
    from feature_tracker_tpu.ops.detect import detect_good_features
    from feature_tracker_tpu.utils.viz import render_matches
    from feature_tracker_tpu_torch.demos import match_brief_demo

    ref, cur, source = synthetic[0]
    got = match_brief_demo.run(ref, cur, source, device="cpu",
                               out_dir=str(tmp_path))
    cap = jax_constants("match_brief_demo")["MAX_FEATURES"]
    ref_j, cur_j = jnp.asarray(ref), jnp.asarray(cur)
    opts = HarrisOptions(min_feature_distance=20, min_valid_response=40.0)
    ref_uv, n_ref = detect_good_features(ref_j, cap, opts)
    cur_uv, n_cur = detect_good_features(cur_j, cap, opts)
    n_ref, n_cur = int(n_ref), int(n_cur)
    ref_bits, ref_valid = compute_brief(ref_j, ref_uv[:n_ref])
    cur_bits, cur_valid = compute_brief(cur_j, cur_uv[:n_cur])
    dist = jnp.where(ref_valid[:n_ref, None] & cur_valid[None, :n_cur],
                     hamming_distance_matrix(ref_bits, cur_bits), jnp.inf)
    idx = nearby_match(dist, ref_uv[:n_ref], cur_uv[:n_cur],
                       max_valid_distance=60.0, max_col_distance=50.0,
                       max_row_distance=50.0)
    matched_uv, status = fill_matched_pixels(idx, cur_uv[:n_cur])
    assert (got["n_ref"], got["n_cur"]) == (n_ref, n_cur)
    for key, want in [("ref_uv", ref_uv[:n_ref]), ("cur_uv", cur_uv[:n_cur]),
                      ("ref_bits", ref_bits), ("cur_bits", cur_bits),
                      ("idx", idx), ("matched_uv", matched_uv),
                      ("status", status)]:
        np.testing.assert_array_equal(got[key], np.asarray(want), key)
    assert got["tracked"] == int((np.asarray(status) == TRACKED).sum()) > 200
    np.testing.assert_array_equal(
        got["png"]["match_brief.png"],
        render_matches(ref, cur, np.asarray(ref_uv[:n_ref]),
                       np.asarray(matched_uv), np.asarray(status)))
    assert_writes_only(tmp_path, got, ["match_brief.png"])


# ----------------------------------------------------------- slam_demo
BA_Q_TOL, BA_T_TOL, BA_LM_RTOL, BA_LM_ATOL = 1e-4, 1e-3, 1e-3, 5e-3


def jax_slam_window(results, disparity, shape, nudge=False):
    """demos/slam_demo.py's landmarks, window and BA on the JAX package,
    from the front end's ``results``; with ``nudge`` every observation
    moves by one ulp. Returns the window after ``optimize`` and the rms
    history, the landmark count, observation count, and the inputs of the
    direct cross-check (``ref_uv``, ``p_c_ref``)."""
    from feature_tracker_tpu.parallel.ba import BaOptions
    from feature_tracker_tpu.parallel.window_ba import (
        SlidingWindowBa,
        WindowConfig,
    )

    c = jax_constants("slam_demo")
    h, w = shape
    r0 = results[0]
    uv0 = r0.uv
    disp = disparity[np.clip(uv0[:, 1].astype(int), 0, h - 1),
                     np.clip(uv0[:, 0].astype(int), 0, w - 1)]
    depth = c["FX"] * c["BASELINE"] / np.maximum(disp, 1.0)
    usable = (r0.track_ids >= 0) & (disp > 1.0) & (depth < 80.0)
    p_w = np.stack([(uv0[:, 0] - c["CX"]) / c["FX"] * depth,
                    (uv0[:, 1] - c["CY"]) / c["FY"] * depth, depth], -1)
    k4 = np.array([c["FX"], c["FY"], c["CX"], c["CY"]], np.float32)
    n = len(results)
    wba = SlidingWindowBa(k4, WindowConfig(max_keyframes=n, max_landmarks=512,
                                           obs_per_landmark=n),
                          BaOptions(max_iterations=20, landmark_prior=30.0,
                                    huber_px=2.0))
    kf = [wba.add_keyframe([1, 0, 0, 0], [0, 0, 0]) for _ in results]
    slots = {lane: wba.add_landmark(p_w[lane])
             for lane in np.nonzero(usable)[0]}
    n_obs = 0
    for r in results:
        for lane, slot in slots.items():
            if (r.track_ids[lane] == r0.track_ids[lane]
                    and r.status[lane] == TRACKED):
                uv = r.uv[lane]
                if nudge:
                    uv = np.nextafter(uv, np.float32(np.inf))
                wba.add_observation(slot, kf[r.frame_id], uv)
                n_obs += 1
    rms = np.asarray(wba.optimize())
    return (wba, rms, len(slots), n_obs, uv0[usable].astype(np.float32),
            p_w[usable].astype(np.float32))


def test_slam_demo_matches_jax(synthetic, tmp_path):
    from feature_tracker_tpu.core.geometry import quat_to_matrix
    from feature_tracker_tpu.pipeline import FrontEndConfig, TrackingFrontEnd
    from feature_tracker_tpu.utils.viz import render_tracked_features
    from feature_tracker_tpu_torch.demos import slam_demo

    left, disp, curs, source = synthetic[1]
    got = slam_demo.run(left, disp, curs, source, device="cpu",
                        out_dir=str(tmp_path))
    frames = [left] + curs
    fe = TrackingFrontEnd(FrontEndConfig())
    results = [fe.process_frame(f) for f in frames]
    assert got["track_calls"] == len(frames) - 1
    for g, w in zip(got["results"], results):
        assert g.frame_id == w.frame_id and g.num_live == w.num_live
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
        assert_statuses(g.status, w.status)
        assert_tracked_uv(g.uv, g.status, w.uv, w.status, UV_TOL["basic"])

    wba, rms, n_lm, n_obs, ref_uv, p_c_ref = jax_slam_window(
        results, disp, left.shape)
    _, rms_nudged, *_ = jax_slam_window(results, disp, left.shape, True)
    spread = float(np.abs(rms_nudged / rms - 1).max())
    assert (got["landmarks"], got["n_obs"]) == (n_lm, n_obs)
    assert n_lm > 250 and n_obs == n_lm * len(frames)
    rel = float(np.abs(got["rms"] / rms - 1).max())
    assert rel <= max(BA_RMS_RTOL, 2.0 * spread), (rel, spread)
    assert got["rms"][-1] < 0.1 < got["rms"][0]
    q, t, lm = got["window"]
    np.testing.assert_allclose(q, wba.q_cw, rtol=0, atol=BA_Q_TOL)
    np.testing.assert_allclose(t, wba.t_cw, rtol=BA_T_TOL, atol=BA_T_TOL)
    np.testing.assert_allclose(lm, wba.landmarks, rtol=BA_LM_RTOL,
                               atol=BA_LM_ATOL)
    rot = np.asarray(quat_to_matrix(jnp.asarray(wba.q_cw)))
    cam_ba = -np.einsum("kij,kj->ki", rot.transpose(0, 2, 1), wba.t_cw)
    np.testing.assert_allclose(got["cam_ba"], cam_ba, rtol=0, atol=BA_T_TOL)

    c = jax_constants("slam_demo")
    poses = jax_direct_poses(left, disp, curs, ref_uv, p_c_ref, 5)
    cam_direct = np.stack([np.zeros(3)] + [p for _, _, p, _ in poses])
    np.testing.assert_allclose(got["cam_direct"], cam_direct, rtol=0,
                               atol=POSE_TOL)
    # Both estimators see the pure translation of the synthetic set.
    truth = np.array([[-2 * k * c["BASELINE"] / 64.0, 0, 0]
                      for k in range(len(frames))])
    np.testing.assert_allclose(got["cam_direct"], truth, rtol=0, atol=1e-5)
    assert np.abs(got["cam_ba"] - truth).max() < 5e-3
    np.testing.assert_allclose(got["err"], np.linalg.norm(
        got["cam_ba"][1:] - got["cam_direct"][1:], axis=1))

    (g_prev, g_last), (w_prev, w_last) = got["results"][-2:], results[-2:]
    want_png = render_tracked_features(frames[-1], w_prev.uv, w_last.uv,
                                       w_last.status)
    name = "slam_front_end_tracks.png"
    assert_overlay_close(got["png"][name], want_png, g_prev.uv, w_prev.uv,
                         g_last.uv, w_last.uv, g_last.status, w_last.status)
    assert got["png"]["slam_trajectory.png"].shape == (420, 420, 3)
    assert_writes_only(tmp_path, got, ["slam_trajectory.png", name])
