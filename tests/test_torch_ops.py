"""CPU parity of the port's image ops with the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in feature_tracker_tpu_torch, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.core.config import HarrisOptions as JaxHarris
from feature_tracker_tpu.ops import detect as jax_detect
from feature_tracker_tpu.ops import interp as jax_interp
from feature_tracker_tpu.ops import solve as jax_solve
from feature_tracker_tpu.ops import window as jax_window
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu_torch.core.config import HarrisOptions
from feature_tracker_tpu_torch.ops import detect, interp, solve, window
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid

from synthetic import translated_pair


@pytest.mark.parametrize("shape,levels", [((120, 160), 4), ((67, 91), 3),
                                          ((33, 50), 1)])
def test_pyramid_levels_bit_equal(shape, levels):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape).astype(np.float32)
    want = jax_pyramid(jnp.asarray(img), levels)
    got = build_pyramid(img, levels, device="cpu")
    assert len(got) == levels
    for a, b in zip(want, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pyramid_floors_non_integer_input_and_batches():
    ref, cur = translated_pair(h=60, w=80)
    want = jax_pyramid(jnp.asarray(ref), 3)
    got = build_pyramid(np.stack([ref, cur]), 3, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
        assert torch.equal(b, torch.floor(b))
    unq = build_pyramid(ref, 2, quantize=False, device="cpu")
    np.testing.assert_array_equal(unq[0].numpy(), ref)


def test_pyramid_warns_on_normalized_input():
    img = np.random.default_rng(1).uniform(0, 1, (16, 16)).astype(np.float32)
    with pytest.warns(UserWarning, match="normalized"):
        build_pyramid(img, 2, device="cpu")


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pyramid(np.zeros((8, 8), np.float32), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detect.detect_good_features(np.zeros((8, 8), np.float32), 4)


def test_solve2x2_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 64)).astype(np.float32)
    h00, h11 = a[0] ** 2 + 1, a[1] ** 2 + 1
    want = np.stack([np.asarray(jax_solve.solve2x2(*(jnp.asarray(x[i])
                                                     for x in (h00, a[2],
                                                               h11, a[3],
                                                               a[4]))))
                     for i in range(64)])
    got = solve.solve2x2(*(torch.from_numpy(x)
                           for x in (h00, a[2], h11, a[3], a[4])))
    np.testing.assert_array_equal(want, got.numpy())


def test_window_ops_match_jax():
    """Batched gather (with the anchor clip far off-image), constant
    weights and tap validity, against the JAX per-feature functions."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 56)).astype(np.float32)
    pad, win = 18, 16
    uv = np.concatenate([rng.uniform(-5, 60, (20, 2)),
                         [[-400.0, 20.0], [30.0, 900.0], [-0.5, -0.5]]]
                        ).astype(np.float32)
    jpad = jax_window.pad_image(jnp.asarray(img), pad)
    tpad = window.pad_image(torch.from_numpy(img), pad)
    np.testing.assert_array_equal(np.asarray(jpad), tpad.numpy())

    r0, c0, w = window.const_weights(torch.from_numpy(uv))
    blocks = window.slice_window(tpad, pad, r0 - 7, c0 - 7, win)
    valid = window.tap_validity(img.shape, r0 - 7, c0 - 7, 15, 15)
    for k in range(len(uv)):
        jr, jc, jw = jax_window.const_weights(jnp.asarray(uv[k]))
        assert (int(jr), int(jc)) == (int(r0[k]), int(c0[k]))
        np.testing.assert_array_equal(np.asarray(jw),
                                      [float(x[k]) for x in w])
        jb = jax_window.slice_window(jpad, pad, jr - 7, jc - 7, win)
        np.testing.assert_array_equal(np.asarray(jb), blocks[k].numpy())
        jv = jax_window.tap_validity(img.shape, jr - 7, jc - 7, 15, 15)
        np.testing.assert_array_equal(np.asarray(jv), valid[k].numpy())


@pytest.mark.parametrize("rows,cols", [(13, 13), (15, 7)])
def test_extract_patch_window_matches_jax(rows, cols):
    """Batched over features against jax.vmap of the per-feature function:
    features inside, on every border and far off the image; bit-equal."""
    import jax

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 56)).astype(np.float32)
    pad = 20
    uv = np.concatenate([rng.uniform(8, 30, (8, 2)),
                         [[0.0, 0.0], [-0.5, 20.0], [55.0, 20.3],
                          [54.7, 38.9], [20.2, -3.5], [30.5, 39.2],
                          [-400.0, 20.0], [30.0, 900.0]]]).astype(np.float32)
    jpad = jax_window.pad_image(jnp.asarray(img), pad)
    want_p, want_ok = jax.vmap(
        lambda p: jax_window.extract_patch_window(jpad, pad, img.shape, p,
                                                  rows, cols))(
        jnp.asarray(uv))
    tpad = window.pad_image(torch.from_numpy(img), pad)
    got_p, got_ok = window.extract_patch_window(
        tpad, pad, img.shape, torch.from_numpy(uv), rows, cols)
    assert got_p.shape == got_ok.shape == (len(uv), rows, cols)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_ok[0].all() and not got_ok[-2:].any()
    assert got_ok[8:14].any(dim=(1, 2)).all()
    assert not got_ok[8:14].all(dim=(1, 2)).any()   # cut by a border


def test_bilinear_taps_match_jax_and_wide_patches_are_refused():
    """The four tap views of a batch of blocks equal JAX's per block. JAX's
    extract_patch_window slices a square window of rows + 1, so for
    cols > rows its views come out short and its sum fails; the port
    refuses such a patch."""
    block = np.random.default_rng(6).normal(size=(3, 9, 9)).astype(
        np.float32)
    got = window.bilinear_taps(torch.from_numpy(block), 8, 5)
    for k in range(3):
        want = jax_window.bilinear_taps(jnp.asarray(block[k]), 8, 5)
        for a, b in zip(want, got):
            assert b.shape == (3, 8, 5)
            np.testing.assert_array_equal(np.asarray(a), b[k].numpy())
    img = np.zeros((20, 30), np.float32)
    uv = np.array([10.2, 8.7], np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_window.extract_patch_window(jax_window.pad_image(
            jnp.asarray(img), 10), 10, img.shape, jnp.asarray(uv), 7, 9)
    with pytest.raises(ValueError, match="cols"):
        window.extract_patch_window(window.pad_image(
            torch.from_numpy(img), 10), 10, img.shape, torch.from_numpy(uv),
            7, 9)


def test_shi_tomasi_response_matches_jax():
    ref, _ = translated_pair(h=120, w=160)
    for half in (1, 2):
        want = np.asarray(jax_detect.shi_tomasi_response(jnp.asarray(ref),
                                                         half))
        got = detect.shi_tomasi_response(torch.from_numpy(ref), half)
        # The response is half the trace of the structure tensor minus a
        # root of nearly the same size: what the two frameworks' box sums
        # round apart scales with the trace, not with the response.
        img = torch.from_numpy(ref)
        dx, dy = torch.zeros_like(img), torch.zeros_like(img)
        dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
        dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
        trace = detect._box_filter(dx * dx + dy * dy, half)
        # 2e-6 is the worst case of a 25-term float32 sum (observed
        # 2.4e-7 of the trace).
        assert trace.max() > 1e2
        excess = np.abs(got.numpy() - want) - 2e-6 * trace.numpy()
        assert excess.max() <= 1e-5, excess.max()


def _tied_image():
    """Integer image of repeated identical blobs: many exactly tied
    responses, so top-K order decides which candidates win."""
    img = np.zeros((96, 128), np.float32)
    for y in range(10, 90, 16):
        for x in range(10, 120, 16):
            img[y:y + 5, x:x + 5] = 200.0
    return img


@pytest.mark.parametrize("case", ["translated_pair", "tied"])
def test_detect_good_features_identical(case):
    if case == "tied":
        img = _tied_image()
        opts = dict(min_feature_distance=12, min_valid_response=10.0)
        max_num = 40
    else:
        img, _ = translated_pair(h=120, w=160)
        opts = dict(min_feature_distance=10, min_valid_response=20.0)
        max_num = 100
    juv, jnum = jax_detect.detect_good_features(jnp.asarray(img), max_num,
                                                JaxHarris(**opts))
    tuv, tnum = detect.detect_good_features(img, max_num,
                                            HarrisOptions(**opts),
                                            device="cpu")
    assert tnum.dtype == torch.int32 and tuv.shape == (max_num, 2)
    assert int(tnum) == int(jnum) > 10
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    if case == "tied":
        resp = detect.shi_tomasi_response(torch.from_numpy(img))
        sel = tuv[:int(tnum)].long()
        scores = resp[sel[:, 1], sel[:, 0]]
        assert len(torch.unique(scores)) < int(tnum)  # ties were decided


def test_greedy_suppression_is_the_sequential_scan():
    rng = np.random.default_rng(4)
    k = 700
    xy = rng.uniform(0, 60, (k, 2))
    d2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    conflict = d2 < 16.0
    valid = rng.uniform(size=k) < 0.9
    want = np.zeros(k, bool)
    for i in range(k):
        want[i] = valid[i] and not (conflict[i, :i] & want[:i]).any()
    got = detect.greedy_suppression(torch.from_numpy(valid),
                                    torch.from_numpy(conflict), chunk=128)
    np.testing.assert_array_equal(got.numpy(), want)
    jgot = jax_detect.greedy_suppression(jnp.asarray(valid),
                                         jnp.asarray(conflict), chunk=128)
    np.testing.assert_array_equal(np.asarray(jgot), want)


def _image(h=40, w=56, seed=3):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(
        np.float32)


def test_bilinear_sample_matches_jax_and_masks_runaway_positions():
    img = _image()
    rng = np.random.default_rng(4)
    pos = rng.uniform(-3, 60, (5, 17, 2)).astype(np.float32)
    pos[0, :4] = [[0.0, 0.0], [54.0, 38.0], [54.999, 38.999], [55.0, 20.0]]
    want_v, want_ok = jax_interp.bilinear_sample(jnp.asarray(img),
                                                 jnp.asarray(pos))
    got_v, got_ok = interp.bilinear_sample(torch.from_numpy(img),
                                           torch.from_numpy(pos))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6,
                               atol=1e-4)
    assert got_ok.numpy()[0, :4].tolist() == [True, True, True, False]
    # Positions no integer can hold, infinite or NaN: invalid, read 0, and
    # nothing raises.
    wild = torch.tensor([[1e20, 5.0], [5.0, -1e20], [np.inf, 5.0],
                         [5.0, -np.inf], [np.nan, 5.0], [5.0, np.nan],
                         [3e9, 3e9]], dtype=torch.float32)
    v, ok = interp.bilinear_sample(torch.from_numpy(img), wild)
    assert not ok.any() and (v == 0).all()


def test_extract_const_weight_patch_and_inner_gradients_match_jax():
    import jax

    img = _image()
    uv = np.array([[20.3, 15.7], [0.5, 0.5], [54.2, 38.9], [-20.0, 5.0],
                   [30.0, 20.0], [55.9, 2.1]], np.float32)
    want_p, want_ok = jax.vmap(lambda p: jax_interp.extract_const_weight_patch(
        jnp.asarray(img), p, 9, 7))(jnp.asarray(uv))
    got_p, got_ok = interp.extract_const_weight_patch(
        torch.from_numpy(img), torch.from_numpy(uv), 9, 7)
    assert got_p.shape == (6, 9, 7)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-4)
    assert not got_ok[3].any() and got_ok[4].all()
    want_dx, want_dy = jax.vmap(jax_interp.inner_gradients)(want_p, want_ok)
    got_dx, got_dy = interp.inner_gradients(got_p, got_ok)
    assert got_dx.shape == (6, 7, 5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=2e-4)
    np.testing.assert_allclose(got_dy.numpy(), np.asarray(want_dy), atol=2e-4)
    # A border patch has masked gradients, an interior one none.
    assert (got_dx[1] == 0).any() and (got_dx[4] != 0).all()


@pytest.mark.parametrize("dim", [3, 6])
def test_solve_sym_matches_jax_including_singular(dim):
    """Well-conditioned systems agree to float32 accuracy; singular ones
    (zero matrix, zero row and column) raise nothing and are non-finite
    where JAX's are, so the engine's NaN test fires on the same lanes."""
    import jax

    rng = np.random.default_rng(dim)
    a = rng.normal(size=(7, 40, dim)).astype(np.float32)
    h = np.einsum("npi,npj->nij", a, a)
    b = rng.normal(size=(7, dim)).astype(np.float32)
    h[1] = 0.0
    b[1] = 0.0
    h[2] = 0.0
    h[3, :, 1] = 0.0
    h[3, 1, :] = 0.0
    b[3, 1] = 0.0
    want = np.asarray(jax.vmap(jax_solve.solve_sym)(jnp.asarray(h),
                                                     jnp.asarray(b)))
    got = solve.solve_sym(torch.from_numpy(h), torch.from_numpy(b)).numpy()
    good = [0, 4, 5, 6]
    np.testing.assert_allclose(got[good], want[good], rtol=2e-3, atol=1e-5)
    for lane in (1, 2, 3):
        assert not np.isfinite(want[lane]).all()
        assert not np.isfinite(got[lane]).all()
        assert np.isnan(got[lane]).any() == np.isnan(want[lane]).any(), lane
    assert solve.solve_sym(torch.zeros(0, dim, dim),
                           torch.zeros(0, dim)).shape == (0, dim)


def test_engine_selects_tuple_state_lane_by_lane():
    """A tuple state (as the affine and SE(2) trackers carry) is updated
    lane by lane, like JAX's pytree select."""
    import jax

    from feature_tracker_tpu.core.config import KltOptions as JaxOptions
    from feature_tracker_tpu.trackers.klt import engine as jax_engine
    from feature_tracker_tpu_torch.core.config import KltOptions
    from feature_tracker_tpu_torch.trackers.klt import engine

    rate = np.array([0.5, 1.0, np.nan, 0.5, 2.1], np.float32)
    n_valid = np.array([5, 5, 5, 0, 5], np.int32)
    uv0 = np.zeros((5, 2), np.float32) + np.float32(0.25)
    m0 = np.tile(np.eye(2, dtype=np.float32), (5, 1, 1))
    status0 = np.full(5, 2, np.int8)

    def jax_one(uv, m, r, nv):
        def step(state):
            u, mm = state
            v = (2.0 - u) * r
            return jax_engine.StepResult(nv, v, (u + v, mm + v[0]),
                                         jax_engine.NO_BREAK)
        return jax_engine.run_klt_iterations(
            step, (uv, m), jnp.int8(2), False, JaxOptions(max_iterations=8),
            True)

    (want_uv, want_m), want_st = jax.vmap(jax_one)(
        jnp.asarray(uv0), jnp.asarray(m0), jnp.asarray(rate),
        jnp.asarray(n_valid))

    t_rate = torch.from_numpy(rate)[:, None]

    def step(state):
        u, mm = state
        v = (2.0 - u) * t_rate
        return engine.StepResult(torch.from_numpy(n_valid), v,
                                 (u + v, mm + v[:, 0, None, None]),
                                 torch.zeros(5, dtype=torch.int8))

    (uv, m), st, steps = engine.run_klt_iterations(
        step, (torch.from_numpy(uv0), torch.from_numpy(m0)),
        torch.from_numpy(status0), torch.zeros(5, dtype=torch.bool),
        KltOptions(max_iterations=8), True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
    np.testing.assert_allclose(uv.numpy(), np.asarray(want_uv), atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), atol=1e-5)
    np.testing.assert_array_equal(m.numpy()[[2, 3]], m0[[2, 3]])  # untouched
    assert steps.tolist()[2:4] == [1, 1]


# --- the kernels' build module (no compiler needed here) ---------------------


def _fake_nvcc(monkeypatch, tmp_path):
    """Point the build module at ``tmp_path`` and replace nvcc by a stand-in
    that records its arguments and writes an empty library."""
    from feature_tracker_tpu_torch.ops import _build

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return _build.subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return _build, calls


def test_library_path_builds_once_and_per_fmad_setting(monkeypatch, tmp_path):
    _build, calls = _fake_nvcc(monkeypatch, tmp_path)
    plain = _build.library_path("ftk_x", ("klt_fast.cu",))
    fused = _build.library_path("ftk_x", ("klt_fast.cu",), True)
    assert plain != fused and len(calls) == 2
    assert "--fmad=false" in calls[0] and "--fmad=true" not in calls[0]
    assert "--fmad=true" in calls[1] and "--fmad=false" not in calls[1]
    assert calls[0][-1].endswith("csrc/klt_fast.cu")
    # Present already: loaded as it is.
    assert _build.library_path("ftk_x", ("klt_fast.cu",)) == plain
    assert len(calls) == 2
    assert _build.build_libraries([("ftk_x", ("klt_fast.cu",)),
                                   ("ftk_x", ("klt_fast.cu",), True)]) == [
        plain, fused]


def test_phase_clock_library_wraps_the_kernel_source(monkeypatch, tmp_path):
    _build, calls = _fake_nvcc(monkeypatch, tmp_path)
    name, sources, fmad = _build.phase_clock_library(
        "ftk_raft_lookup_phases", "raft_lookup.cu", True)
    assert name == "ftk_raft_lookup_phases" and fmad is True
    (wrapper,) = sources
    text = open(wrapper).read()
    assert "#define FTK_PHASE_CLOCKS 1" in text
    assert text.rstrip().endswith('csrc/raft_lookup.cu"')
    # The kernel's source carries the marks and the header the clocks.
    csrc = _build.CSRC_DIR
    assert "FTK_MARK(" in open(f"{csrc}/raft_lookup.cu").read()
    assert "FTK_MARK(" in open(f"{csrc}/klt_affine.cu").read()
    assert "ftk_phase_clocks_read" in open(f"{csrc}/klt_common.cuh").read()
    # The wrapper is the one source handed to the compiler (an absolute
    # path), and an unchanged kernel leaves it untouched.
    _build.library_path(name, sources, fmad)
    assert calls[0][-1] == wrapper
    before = open(wrapper).read()
    assert _build.phase_clock_library(name, "raft_lookup.cu", True)[1] == (
        wrapper,)
    assert open(wrapper).read() == before


def test_fast_kernel_phase_marks_and_diagnostics(monkeypatch, tmp_path):
    """klt_fast.cu marks every phase of FAST_PHASES and exports its
    occupancy; without a card the diagnostics raise before any build."""
    import re

    from feature_tracker_tpu_torch.core.config import KltOptions
    from feature_tracker_tpu_torch.ops import cuda_klt

    _build, calls = _fake_nvcc(monkeypatch, tmp_path)
    text = open(f"{_build.CSRC_DIR}/klt_fast.cu").read()
    marks = {int(m) for m in re.findall(r"FTK_MARK\(phases, (\d+),", text)}
    assert marks == set(range(len(cuda_klt.FAST_PHASES)))
    assert "int ftk_klt_fast_occupancy(" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    uv = torch.zeros(3, 2)
    with pytest.raises(RuntimeError, match="fast_occupancy needs a CUDA"):
        cuda_klt.fast_occupancy(KltOptions())
    with pytest.raises(RuntimeError, match="fast_phase_clocks needs a CUDA"):
        cuda_klt.fast_phase_clocks(KltOptions(), [], [], uv, uv,
                                   torch.zeros(3, dtype=torch.bool))
    assert calls == []
