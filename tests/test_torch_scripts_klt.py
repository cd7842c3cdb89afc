"""The ports of ``scripts/time_klt_modes.py``, ``scripts/klt_multipair.py``
and ``scripts/cotracker_r5_sweep.sh`` (``feature_tracker_tpu_torch/
scripts/``) against the JAX scripts, on the CPU, and the public names of
all three Python scripts.

No JAX script is imported (``klt_multipair.py`` points JAX's compilation
cache into the repository when imported): their computations are rebuilt
from the JAX package, and ``load_pairs`` is compiled from its source alone.

Tolerances:
  - inputs, pyramids, composite pyramids and the un-offsetting: bit-equal;
  - ``tracked`` of ``time_klt_modes``: equal to JAX's ``BasicKlt``;
  - composite against sequential: statuses equal and uv within 0.2 px on
    the features at least ``parity_margin`` (64) rows inside their crop.
    Nearer the crop's top or bottom a coarse level's patch reads the zero
    gap where the pair alone has its border rule (``trackers/klt/
    multi.py``, in JAX too). 0.2 px is the tracker's stop rule
    (``max_converge_step`` 4e-2 on the squared step): a pair's positions
    offset into its band differ by a float32 rounding (up to 6.1e-5 px at
    the composite's heights), which can end the Gauss-Newton loop one
    step of under 0.2 px earlier or later;
  - against the native CPU port: at most 0.1 % of the statuses differ, and
    at least one may, as in ROADMAP.md's rule.
"""

import ast
import inspect
import re
import shlex
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.core.config import KltMethod as JaxKltMethod
from feature_tracker_tpu.core.config import KltOptions as JaxKltOptions
from feature_tracker_tpu.ops.pyramid import build_pyramid as jax_pyramid
from feature_tracker_tpu.trackers.klt import BasicKlt as JaxBasicKlt
from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.scripts import klt_multipair, time_klt_modes
from feature_tracker_tpu_torch.train import cotracker_pretrain
from feature_tracker_tpu_torch.trackers.klt.multi import (
    build_composite_pyramids,
)

from synthetic import translated_pair

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPTS = REPO / "scripts"
PORT_SCRIPTS = REPO / "feature_tracker_tpu_torch" / "scripts"
STOP_STEP = 0.2                 # px: sqrt(KltOptions.max_converge_step)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def public_names(path):
    """Functions, classes and upper-case constants defined at the top level
    and not starting with ``_``, read from the source."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name) and t.id.isupper()}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("script", ["raft_bf16_eval", "time_klt_modes",
                                    "klt_multipair"])
def test_ported_script_has_the_jax_public_names(script):
    want = public_names(JAX_SCRIPTS / f"{script}.py")
    assert want and want <= public_names(PORT_SCRIPTS / f"{script}.py")


def test_nothing_imports_the_jax_scripts():
    """The JAX scripts configure a compile cache when imported and two of
    their modes rewrite weights/metrics.json: no test and no module of the
    port imports them."""
    files = [*(REPO / "feature_tracker_tpu_torch").rglob("*.py"),
             *(REPO / "tests").glob("*.py"), REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            assert not any(m == "scripts" or m.startswith("scripts.")
                           for m in mods), (path, mods)


# ---------------------------------------------------------- time_klt_modes
def test_time_klt_inputs_are_the_jax_scripts():
    """The fallback pair (the JAX script has none: that of its sibling
    klt_multipair.py), the JAX script's features and 4-level pyramids."""
    rp, cp, uv, source = time_klt_modes.klt_inputs(device="cpu")
    assert source == "synthetic"
    ref, cur = translated_pair(h=480, w=752, shift=(7.0, -4.0))
    n = 10240
    rng = np.random.default_rng(0)
    want = np.stack([rng.uniform(20, ref.shape[1] - 20, n),
                     rng.uniform(20, ref.shape[0] - 20, n)],
                    -1).astype(np.float32)
    np.testing.assert_array_equal(uv.numpy(), want)
    for got, img in ((rp, ref), (cp, cur)):
        for a, b in zip(got, jax_pyramid(jnp.asarray(img), 4), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["fast", "direct", "inverse"])
def test_time_klt_tracked_equals_jax_basic_klt(mode):
    n = 256
    got = time_klt_modes.run(mode, n=n, iters=1, rounds=1, device="cpu")
    rp, cp, uv, _ = time_klt_modes.klt_inputs(n, device="cpu")
    method = {"fast": JaxKltMethod.FAST, "direct": JaxKltMethod.DIRECT,
              "inverse": JaxKltMethod.INVERSE}[mode]
    jax_tracker = JaxBasicKlt(JaxKltOptions(max_track_points=n,
                                            method=method))
    _, status = jax_tracker.track([jnp.asarray(x.numpy()) for x in rp],
                                  [jnp.asarray(x.numpy()) for x in cp],
                                  uv.numpy())
    assert got["tracked"] == int((np.asarray(status) == 1).sum())
    assert got["tracked"] > 0.9 * n
    assert got["launches_per_call"] == 0 and got["card"] == "cpu"
    assert {"mode", "ms", "tracked"} <= set(got)


@pytest.mark.parametrize("args", [("qpf",), ("qdt",), ("qdtv",), ("slow",),
                                  ("fast", 4), ("direct", 128)])
def test_time_klt_refuses_the_tpu_kernels_options(args):
    """The TPU kernel's other bias formulations and its features-per-grid-
    step tile have no CUDA counterpart: refused, never timed as the one
    kernel under another name."""
    with pytest.raises(ValueError, match="TPU kernel"):
        time_klt_modes.run(*args, device="cpu")
    with pytest.raises(ValueError, match="TPU kernel"):
        time_klt_modes.main([*map(str, args), "--device", "cpu"])


# ----------------------------------------------------------- klt_multipair
def jax_load_pairs():
    """The JAX script's ``load_pairs``, compiled from its source alone."""
    path = JAX_SCRIPTS / "klt_multipair.py"
    node = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "load_pairs")
    ns = {"np": np}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path),
                 "exec"), ns)
    return ns["load_pairs"]


def test_composite_pyramids_are_the_jax_scripts():
    """K=2 crops of 64x96, gap 128: the crops and features are the JAX
    script's, and ``build_composite_pyramids`` stacks the per-pair levels
    as the script does (JAX's own pyramids, a zero band of gap >> level
    rows after each pair)."""
    k, h, w, n, gap, levels = 2, 64, 96, 16, 128, 4
    pairs = klt_multipair.load_pairs(k, h, w)
    want_pairs = jax_load_pairs()(k, h, w)
    for (r, c), (jr, jc) in zip(pairs, want_pairs, strict=True):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(20, w - 20, (k, n)),
                   rng.uniform(20, h - 20, (k, n))], -1).astype(np.float32)
    np.testing.assert_array_equal(klt_multipair.features(k, h, w, n), uv)

    for side in (0, 1):
        jpyrs = [jax_pyramid(jnp.asarray(p[side]), levels) for p in pairs]
        want = []
        for lvl in range(levels):
            z = jnp.zeros((gap >> lvl, jpyrs[0][lvl].shape[1]), jnp.float32)
            want.append(jnp.concatenate(
                [jnp.concatenate([p[lvl], z], 0) for p in jpyrs], 0))
        got, band = build_composite_pyramids(
            [build_pyramid(p[side], levels, device="cpu") for p in pairs],
            gap=gap)
        assert band == h + gap
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unoffsetting_is_the_jax_scripts():
    """``offset_rows(x, -band)`` is the script's ``cuv_c[..., 1] -= band *
    arange(k)`` bit for bit, and moving features into their bands and back
    returns them within half an ulp of the composite's rows."""
    k, h, w, n = 3, 320, 512, 500
    band = h + klt_multipair.GAP
    rng = np.random.default_rng(5)
    x = rng.uniform(0, k * band, (k, n, 2)).astype(np.float32)
    want = x.copy()
    want[..., 1] -= band * np.arange(k, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(klt_multipair.offset_rows(x, -band), want)
    uv = klt_multipair.features(k, h, w, n)
    back = klt_multipair.offset_rows(klt_multipair.offset_rows(uv, band),
                                     -band)
    np.testing.assert_array_equal(back[0], uv[0])
    np.testing.assert_array_equal(back[..., 0], uv[..., 0])
    half_ulp = np.spacing(np.float32(k * band)) / 2
    assert np.abs(back - uv).max() <= half_ulp


@pytest.mark.parametrize("k", [1, 2])
def test_multipair_composite_matches_sequential_and_cpu(k):
    """Crops of 160x256 with 256 features each: one composite call against
    k calls and the native CPU port, pair by pair."""
    n = 256
    got = klt_multipair.run(k, 160, 256, n, inner=1, iters=1, rounds=1,
                            device="cpu")
    assert got["interior_margin_px"] == klt_multipair.parity_margin(
        KltOptions()) == 64
    assert got["status_mismatch_composite_vs_sequential_interior"] == 0
    assert got["max_pos_diff_composite_vs_sequential_interior_px"] <= (
        STOP_STEP)
    assert got["status_mismatch_composite_vs_sequential"] <= max(
        1, 1e-3 * k * n) + 2 * k        # the border rows, see above
    assert got["cpu_ms"] > 0            # the native comparison ran
    assert 0 <= got["status_mismatch_vs_cpu"] <= got[
        "status_mismatch_composite_vs_sequential"] + max(1, 1e-3 * k * n)
    assert got["composite_launches"] == got["sequential_launches"] == 0
    assert got["floor_ms"] == 0.0 and got["inner_chain"] == 1
    assert got["tracked_composite"] > 0.9 * k * n
    assert got["launch_amortization"] == pytest.approx(
        got["sequential_ms"] / got["composite_ms"])


def test_multipair_main_takes_the_jax_arguments(monkeypatch, capsys):
    """``[K] [H] [W] [N_per_pair]`` positionally with the JAX script's
    defaults, and the dict printed as one JSON line."""
    monkeypatch.setattr(klt_multipair, "run",
                        lambda *args, device: {"args": list(args),
                                               "device": device})
    assert klt_multipair.main(["--device", "cpu"]) == {
        "args": [2, 320, 512, 5120], "device": "cpu"}
    assert klt_multipair.main(["1", "160"]) == {
        "args": [1, 160, 512, 5120], "device": "cuda"}
    assert capsys.readouterr().out.splitlines()[-1] == (
        '{"args": [1, 160, 512, 5120], "device": "cuda"}')


# ------------------------------------------------------------------ sweep
def sweep_runs(path):
    """The ``run`` lines of a sweep script, continuation lines joined, as
    argument lists."""
    text = path.read_text().replace("\\\n", " ")
    return [shlex.split(line)[1:] for line in text.splitlines()
            if line.startswith("run ")]


def parse_like_main(args):
    """``train/cotracker_pretrain.py``'s ``__main__`` parsing."""
    kw = {}
    for a in args:
        k, v = a.split("=")
        kw[k] = v if k == "device" else int(v)
    return kw


PORT_SWEEP = PORT_SCRIPTS / "cotracker_r5_sweep.sh"


@pytest.mark.parametrize("index", range(4))
def test_sweep_run_binds_to_the_ports_main(index):
    runs = sweep_runs(PORT_SWEEP)
    assert runs == sweep_runs(JAX_SCRIPTS / "cotracker_r5_sweep.sh")
    assert len(runs) == 4
    bound = inspect.signature(cotracker_pretrain.main).bind(
        **parse_like_main(runs[index]))
    assert "device" not in bound.arguments     # the card, by default


def test_sweep_runs_the_ports_trainer_as_the_jax_sweep():
    port, jax_sweep = (p.read_text() for p in (
        PORT_SWEEP, JAX_SCRIPTS / "cotracker_r5_sweep.sh"))
    for text, module in ((port, "feature_tracker_tpu_torch"),
                         (jax_sweep, "feature_tracker_tpu")):
        assert re.search(r"timeout 2400 python3 -m "
                         + re.escape(module)
                         + r"\.train\.cotracker_pretrain", text)
        assert "LOG=${1:-/tmp/cotracker_sweep.log}" in text
    assert PORT_SWEEP.stat().st_mode & 0o111


def test_multipair_without_the_native_port_says_so(monkeypatch, capsys):
    """Where the native CPU port cannot be built (``klt_fast_cpu`` raises
    ``RuntimeError``), the comparison is reported as not made (-1), as in
    the JAX script, never as 0 mismatches."""
    def unavailable(*args, **kw):
        raise RuntimeError("the native CPU baseline library could not be "
                           "built (needs g++)")

    monkeypatch.setattr(klt_multipair, "klt_fast_cpu", unavailable)
    got = klt_multipair.run(1, 160, 256, 32, inner=1, iters=1, rounds=1,
                            device="cpu")
    assert (got["status_mismatch_vs_cpu"], got["max_pos_diff_vs_cpu_px"],
            got["cpu_ms"], got["vs_cpu_composite"]) == (-1, -1.0, -1.0, -1.0)
    assert "CPU port unavailable" in capsys.readouterr().out
