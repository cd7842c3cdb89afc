"""The reference-pair counts of the port's pretraining driver
(``train/pretrain.py``) against the JAX package's, on the CPU: the counts
on a synthetic pair put in place of the reference pair on both sides, and
tests/test_pretrain.py's counting cases on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np

from feature_tracker_tpu.models import lightglue as jlg
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu_torch.convert import (
    lightglue_state_from_jax,
    options_from_jax,
)
from feature_tracker_tpu_torch.models.lightglue import LightGlue
from feature_tracker_tpu_torch.train import pretrain as ppre
from synthetic import translated_pair

from test_torch_pretrain import detectors, jitted  # noqa: F401
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


def test_count_key_anchor_floor():
    """tests/test_pretrain.py's case on the port."""
    assert ppre.BRIEF_ANCHOR_RAW == jpre.BRIEF_ANCHOR_RAW == 171
    incumbent = {"verified": 135, "raw": 185}
    hinge = {"verified": 138, "raw": 157}
    assert ppre._count_key(hinge) > ppre._count_key(incumbent)
    assert ppre._count_key(hinge, 171) < ppre._count_key(incumbent, 171)
    better = {"verified": 140, "raw": 180}
    assert ppre._count_key(better, 171) > ppre._count_key(incumbent, 171)
    a = {"verified": 81, "raw": 87}
    b = {"verified": 87, "raw": 93}
    assert ppre._count_key(b, 171) > ppre._count_key(a, 171)


def test_klt_verified_counts_correct_and_garbage_matches():
    """tests/test_pretrain.py's case on the port, and against JAX."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    img = base.copy()
    for _ in range(2):
        img = np.pad(img, 1, mode="edge")
        img = sum(img[i:i + 96, j:j + 128] * k[i, j]
                  for i in range(3) for j in range(3))
    dx, dy = 3, 2
    cur = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    ruv = np.stack(np.meshgrid(np.arange(24, 104, 16),
                               np.arange(24, 72, 16)), -1)
    ruv = ruv.reshape(-1, 2).astype(np.float32)
    true_uv = ruv + np.array([dx, dy], np.float32)
    garbage_uv = ruv + np.array([17.0, -11.0], np.float32)
    n = len(ruv)
    half = n // 2
    muv = np.concatenate([true_uv[:half], garbage_uv[half:]])
    matched = np.ones(n, bool)

    verified, med = ppre._klt_verified(img, cur, ruv, muv, matched,
                                       device="cpu")
    assert verified == half
    assert med >= 0.0
    assert (verified, med) == jpre._klt_verified(img, cur, ruv, muv, matched)
    v_all, med_all = ppre._klt_verified(img, cur, ruv, true_uv, matched,
                                        device="cpu")
    assert v_all == n
    assert med_all < 1.0


def test_reference_pair_counts(detectors, monkeypatch):
    """The counts on a synthetic 224x160 pair (translated by (2.3, -1.7))
    put in place of the reference pair on both sides: raw and verified
    counts and the median error equal JAX's; None without the pair."""
    assert ppre._load_reference_pair() == (None, None)
    jdet, pdet = detectors["sp"]
    assert ppre.reference_pair_counts(pdet) is None
    assert ppre.reference_pair_match_count(pdet) == -1
    pair = translated_pair(h=160, w=224)
    monkeypatch.setattr(jpre, "_load_reference_pair", lambda: pair)
    monkeypatch.setattr(ppre, "_load_reference_pair", lambda: pair)
    want = jpre.reference_pair_counts(jdet, cap=80)
    got = ppre.reference_pair_counts(pdet, cap=80)
    assert got == want and got["verified"] > 10
    assert pdet.max_features == 32
    cfg = jlg.LightGlueConfig(depth=2)
    lg = jlg.LightGlue(cfg)
    zeros = (jnp.zeros((8, 2)), jnp.zeros((8, 256)), jnp.ones(8, bool))
    lg_vars = jax.jit(lg.init)(jax.random.PRNGKey(0), *zeros, *zeros)
    plg = LightGlue(options_from_jax(cfg), device="cpu")
    pparams = lightglue_state_from_jax(lg_vars)
    want = jpre.reference_pair_lightglue_counts(jdet, jitted(lg), lg_vars,
                                                cap=60)
    got = ppre.reference_pair_lightglue_counts(pdet, plg, pparams, cap=60)
    assert got == want and got["raw"] > 0
    assert ppre.reference_pair_lightglue_count(pdet, plg, pparams,
                                               cap=60) == got["raw"]
