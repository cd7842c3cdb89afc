"""The port of ``scripts/raft_bf16_eval.py``
(``feature_tracker_tpu_torch/scripts/raft_bf16_eval.py``) against the JAX
script's computations, on the CPU.

The JAX script is never imported: it points JAX's compilation cache into
the repository when imported, and its ``anytime`` and ``speed_sidecar``
rewrite ``weights/metrics.json``. Each JAX computation is rebuilt here from
the JAX package's own functions as the script builds it, and
``compact_cfg`` is compiled from the script's source alone. The JAX models
take the port's weights (``convert.flax_variables_from_state``, read back
through JAX's ``load_pytree``), which spares a Flax ``init`` compile.

Tolerances:
  - float32 EPE: 1e-4 px (the port's dict is rounded to 4 digits, as
    JAX's; tests/test_torch_raft.py holds the flows to 3e-6 px);
  - bfloat16 EPE: twice JAX's own bfloat16-minus-float32 EPE gap on the
    same pairs. bfloat16 rounding moves each run's EPE by about that gap,
    and where it lands depends on the order of the sums: JAX's eager and
    jitted bfloat16 models, on the same weights and pairs, lie 0.002 px
    apart. Two bfloat16 runs, each within the gap of float32, lie within
    twice the gap of each other;
  - the lookup loop's final locations: 1e-6 relative (float32, one lookup
    per step in another order of the same sums);
  - the update loop's checksum: 1e-5 relative in float32 (observed
    5e-7); in bfloat16 twice JAX's own distance between its bfloat16 and
    float32 loops, by the EPE's reasoning (at 8x16: JAX 0.135 apart, the
    port 0.129 from JAX's bfloat16 loop).
"""

import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import raft as jax_raft
from feature_tracker_tpu.train.raft_eval import flow_metrics as jax_metrics
from feature_tracker_tpu.train.raft_pretrain import make_pool as jax_pool
from feature_tracker_tpu.utils.weights import load_pytree
from feature_tracker_tpu_torch.convert import (
    flax_variables_from_state,
    options_from_jax,
)
from feature_tracker_tpu_torch.models.layers import flax_init_
from feature_tracker_tpu_torch.models.raft import RaftConfig, UpdateBlock
from feature_tracker_tpu_torch.scripts import raft_bf16_eval
from feature_tracker_tpu_torch.scripts._timing import weights_digest
from feature_tracker_tpu_torch.utils.weights import weights_path

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "raft_bf16_eval.py"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while this module runs: the suite
    runs several test files at once on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def jax_function(name):
    """A top-level function of the JAX script compiled from its source
    alone (the module itself is never run)."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(JAX_SCRIPT),
                 "exec"), ns)
    return ns[name]


def jax_keys(name):
    """The string keys the JAX script's ``name`` puts in its dicts: dict
    literals, subscript assignments, and the names its loops iterate
    over as the first item of a tuple."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        elif isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            keys |= {e.elts[0].value for e in node.iter.elts
                     if isinstance(e, ast.Tuple)
                     and isinstance(e.elts[0], ast.Constant)}
    return {k for k in keys if isinstance(k, str)}


def all_keys(tree):
    if not isinstance(tree, dict):
        return set()
    return set(tree) | {k for v in tree.values() for k in all_keys(v)}


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_compact_cfg_equals_the_jax_scripts(name):
    jdtype, tdtype = DTYPES[name]
    want = jax_function("compact_cfg")(jdtype)
    got = raft_bf16_eval.compact_cfg(tdtype)
    assert got == options_from_jax(want)
    for field in want.__dataclass_fields__:
        value = getattr(want, field)
        if field == "dtype":
            assert getattr(got, field) == tdtype
        else:
            assert getattr(got, field) == value, field
    assert raft_bf16_eval.compact_cfg(tdtype, 12).max_iterations == 12


# ------------------------------------------------------ accuracy, anytime
def test_accuracy_matches_jax_on_one_batch():
    """One batch of 4 held-out pairs (the first of the script's 16)."""
    got = raft_bf16_eval.accuracy(n_batches=1, device="cpu")
    out = got["raft_accuracy_64x64_compact_6it"]
    ref, cur, gt = jax_pool(np.random.default_rng(1000), 1, 64, 64, 4,
                            augment=False)[0]
    want = {}
    for name, (jdtype, tdtype) in DTYPES.items():
        model = raft_bf16_eval._compact_model(tdtype, 6, "cpu")
        variables = load_pytree(weights_path("raft_small.npz"),
                                flax_variables_from_state(model.state_dict()))
        cfg = jax_function("compact_cfg")(jdtype)
        flows = jax.jit(jax_raft.Raft(cfg).apply)(variables, ref, cur)
        want[name] = {k: float(v) for k, v in jax_metrics(
            flows[-1].astype(jnp.float32), gt).items()}
    gap = abs(want["bf16"]["epe"] - want["f32"]["epe"])
    assert 1e-3 < gap < 0.05, want
    assert set(out["f32"]) == set(want["f32"])
    for k, v in want["f32"].items():
        assert abs(out["f32"][k] - v) <= 1e-4, (k, out["f32"][k], v)
    assert abs(out["bf16"]["epe"] - want["bf16"]["epe"]) <= 2 * gap, (
        out, want)
    assert out["epe_delta_bf16_minus_f32"] == round(
        out["bf16"]["epe"] - out["f32"]["epe"], 4)
    assert jax_keys("accuracy") <= all_keys(got)


def test_anytime_writes_only_its_out_file(tmp_path):
    """``--out`` gets the printed dict and nothing else is written:
    ``weights/`` hashes the same before and after, and an ``--out`` under
    ``weights/`` is refused. The float32 EPEs are the JAX model's on the
    CPU (tests/test_torch_raft.py), not the TPU's in metrics.json."""
    before = weights_digest()
    path = tmp_path / "anytime.json"
    got = raft_bf16_eval.main(["anytime", "--device", "cpu", "--out",
                               str(path)])
    assert sorted(os.listdir(tmp_path)) == ["anytime.json"]
    assert json.loads(path.read_text()) == got
    out = got["raft_anytime"]
    assert abs(out["epe_k6"] - 1.7609) <= 1e-4
    assert abs(out["epe_k12"] - 1.7349) <= 1e-4
    assert out["pairs"] == 16 and out["resolution"] == "64x64"
    assert jax_keys("anytime") <= all_keys(got)
    with pytest.raises(SystemExit):
        raft_bf16_eval.main(["anytime", "--device", "cpu", "--out",
                             weights_path("metrics.json")])
    assert weights_digest() == before


# --------------------------------------------------- speed, speed_sidecar
def test_speed_has_the_jax_keys():
    """At 64x128 and 1 / 2 iterations: JAX's keys, with 12 iterations read
    as 2, and the port's launch counts (no kernel on the CPU)."""
    before = weights_digest()
    got = raft_bf16_eval.speed(h=64, w=128, iterations=2, iters=1, rounds=1,
                               device="cpu")
    want = {k.replace("12", "2").replace("1024x440", "128x64")
            for k in jax_keys("speed")}
    extra = {"lookup_launches_per_call", "1it", "2it", "card", "clock"}
    assert all_keys(got) == want | extra
    out = got["raft_speed_128x64"]
    for name in ("f32", "bf16", "bf16_last_up"):
        assert out[name]["lookup_launches_per_call"] == {"1it": 0, "2it": 0}
        assert out[name]["ms_2it"] > 0
        assert (out[name]["encoders_plus_init_ms"]
                + 2 * out[name]["per_iteration_ms"]) == pytest.approx(
                    out[name]["ms_2it"], abs=1e-3)
    assert out["card"] == "cpu" and "CPU" in out["clock"]
    assert weights_digest() == before


def test_speed_sidecar_has_the_jax_keys_and_writes_nothing():
    before = weights_digest()
    got = raft_bf16_eval.speed_sidecar(h=64, w=128, iterations=2, iters=1,
                                       rounds=1, device="cpu")
    want = {k.replace("k12", "k2").replace("k6", "k1")
            for k in jax_keys("speed_sidecar")}
    extra = {"lookup_launches_per_call", "card", "clock"}
    assert all_keys(got) == want | extra
    out = got["raft_speed"]
    assert out["resolution"] == "128x64"
    for key in ("shipped_k2", "shipped_k1", "parity_f32_k2"):
        assert out[key]["lookup_launches_per_call"] == 0
        assert out[key]["fps"] == pytest.approx(1e3 / out[key]["ms"],
                                                abs=0.01)
    assert weights_digest() == before


# ------------------------------------------------------------------ split
def jax_split_inputs(h8, w8, cfg):
    """The JAX script's inputs of ``split`` at ``h8`` x ``w8``."""
    rng = np.random.default_rng(0)
    fmap0 = jnp.asarray(rng.normal(0, 1, (1, h8, w8, cfg.feature_channels)),
                        jnp.float32)
    fmap1 = jnp.asarray(rng.normal(0, 1, (1, h8, w8, cfg.feature_channels)),
                        jnp.float32)
    fpyr = jax_raft.pool_feature_pyramid(fmap1,
                                         cfg.correlation_pyramid_levels)
    gx, gy = jnp.meshgrid(jnp.arange(w8, dtype=jnp.float32),
                          jnp.arange(h8, dtype=jnp.float32))
    ref_locs = jnp.stack([gx, gy], -1)[None]
    n_corr = cfg.correlation_pyramid_levels * (
        2 * cfg.correlation_radius + 1) ** 2
    net0 = jnp.asarray(rng.normal(0, 1, (1, h8, w8, cfg.hidden_channels)),
                       cfg.dtype)
    inp = jnp.asarray(rng.normal(0, 1, (1, h8, w8, cfg.context_channels)),
                      cfg.dtype)
    corr0 = jnp.asarray(rng.normal(0, 1, (1, h8, w8, n_corr)), cfg.dtype)
    flow0 = jnp.zeros((1, h8, w8, 2), cfg.dtype)
    return fmap0, fpyr, ref_locs, net0, inp, corr0, flow0


def jax_update_loop(cfg, variables, net0, inp, corr0, flow0, iters):
    """The JAX script's ``update_loop`` at ``s = 0``."""
    update = jax_raft.UpdateBlock(cfg)

    def body(carry, _):
        net, flow = carry
        corr = corr0 * (1.0 + 1e-20 * jnp.mean(net).astype(cfg.dtype))
        net, up_mask, delta = update.apply(variables, net, inp, corr, flow)
        return (net, flow + delta.astype(cfg.dtype)), jnp.sum(
            up_mask.astype(jnp.float32))

    @jax.jit
    def loop():
        (net, flow), masks = jax.lax.scan(body, (net0, flow0), None,
                                          length=iters)
        return jnp.sum(flow.astype(jnp.float32)) + jnp.sum(masks)

    return float(loop())


H8, W8, SPLIT_ITERS = 8, 16, 12


def test_split_lookup_loop_matches_jax():
    """Twelve lookups from carried locations, through the kernel's wrapper
    (the plain ``lookup_correlation_otf`` on the CPU) and through JAX's
    plain on-the-fly lookup, from the script's inputs."""
    cfg = RaftConfig(low_memory=True, dtype=torch.bfloat16,
                     upsample_last_only=True)
    jcfg = jax_raft.RaftConfig(low_memory=True, dtype=jnp.bfloat16,
                               upsample_last_only=True)
    x = raft_bf16_eval.split_inputs(H8, W8, cfg, "cpu")
    jf0, jpyr, jlocs = jax_split_inputs(H8, W8, jcfg)[:3]
    np.testing.assert_array_equal(x["fmap0"].numpy(), np.asarray(jf0))
    for got, want in zip(x["fpyr"], jpyr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x["ref_locs"].numpy(), np.asarray(jlocs))

    lookup = jax.jit(jax_raft.lookup_correlation_otf, static_argnums=3)
    locs = jlocs
    for _ in range(SPLIT_ITERS):
        corr = lookup(jf0, jpyr, locs, jcfg.correlation_radius)
        locs = locs + 1e-6 * jnp.mean(corr)
    got = raft_bf16_eval.lookup_loop(x["fmap0"], x["fpyr"], x["ref_locs"],
                                     cfg.correlation_radius, SPLIT_ITERS)
    moved = np.asarray(locs) - np.asarray(jlocs)
    assert np.abs(moved[0, 0, 0]).max() > 0     # the carry reached (0, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(locs), rtol=1e-6,
                               atol=1e-12)
    assert float(got.sum()) == pytest.approx(float(jnp.sum(locs)), rel=1e-6)


def test_split_update_loop_matches_jax():
    """Twelve update-block steps from the script's inputs on the same
    (seeded) weights, in float32 and in the script's bfloat16."""
    sums = {}
    for name, (jdtype, tdtype) in DTYPES.items():
        cfg = RaftConfig(low_memory=True, dtype=tdtype,
                         upsample_last_only=True)
        jcfg = jax_raft.RaftConfig(low_memory=True, dtype=jdtype,
                                   upsample_last_only=True)
        update = flax_init_(UpdateBlock(cfg).eval(), 0)
        variables = flax_variables_from_state(update.state_dict())
        x = raft_bf16_eval.split_inputs(H8, W8, cfg, "cpu")
        jx = jax_split_inputs(H8, W8, jcfg)[3:]
        for got, want in zip((x["net0"], x["inp"], x["corr0"], x["flow0"]),
                             jx):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        got = float(raft_bf16_eval.update_loop(
            update, x["net0"], x["inp"], x["corr0"], x["flow0"],
            SPLIT_ITERS))
        sums[name] = (got, jax_update_loop(jcfg, variables, *jx,
                                           SPLIT_ITERS))
    f32, bf16 = sums["f32"], sums["bf16"]
    assert f32[0] == pytest.approx(f32[1], rel=1e-5), sums
    jax_gap = abs(bf16[1] - f32[1])
    assert 0 < jax_gap < 0.01 * abs(f32[1]), sums
    assert abs(bf16[0] - bf16[1]) <= 2 * jax_gap, sums


def test_split_has_the_jax_keys_but_the_note():
    """At 64x128 and 2 iterations: JAX's keys but its ``note``, which cites
    a TPU time, and in its place the whole call's per-iteration time
    measured in the same run."""
    before = weights_digest()
    got = raft_bf16_eval.split(h=64, w=128, iterations=2, iters=1, rounds=1,
                               device="cpu")
    extra = {"whole_call_per_iteration_ms", "lookup_checksum",
             "update_checksum", "lookup_launches_per_loop", "card", "clock"}
    assert all_keys(got) == (jax_keys("split") - {"note"}) | extra
    out = got["raft_iteration_split"]
    assert out["resolution"] == "128x64 (/8: 16x8)"
    assert out["corr_channels"] == 3 * 49 and out["iterations"] == 2
    assert out["lookup_launches_per_loop"] == 0
    assert weights_digest() == before


# ------------------------------------------------------------- the card
@pytest.mark.parametrize("mode", sorted(raft_bf16_eval.MODES))
def test_modes_default_to_the_card(mode):
    """Without a device each mode raises here (no card) before it runs;
    nothing falls back to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raft_bf16_eval.MODES[mode]()
