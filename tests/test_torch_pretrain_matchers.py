"""The matcher stages of the port's pretraining driver
(``train/pretrain.py``) against the JAX package's, on the CPU:
``train_lightglue`` on SuperPoint's descriptors from JAX's ``init`` state
(losses within 1e-5 relative, the match statistics equal) and
``evaluate_matching`` (``train_disk`` and the DISK-descriptor LightGlue in
tests/test_torch_pretrain_disk.py).
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

from test_torch_pretrain import detectors, jitted  # noqa: F401
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


def lightglue_case(detectors, kind, dim):
    """``train_lightglue`` on ``kind``'s shipped detector with ``dim``-wide
    descriptors, three steps from JAX's own initial state."""
    jdet, pdet = detectors[kind]
    kw = dict(steps=3, h=48, w=48, n_kpts=24, seed=1, log_every=1, depth=1,
              descriptor_dim=dim)
    jmodel, _, jhist = jpre.train_lightglue(jdet, **kw)
    # JAX's own initial state, as train_lightglue draws it.
    zeros = (jnp.zeros((24, 2)), jnp.zeros((24, dim)), jnp.ones((24,), bool))
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(1), *zeros, *zeros)
    pmodel, _, phist = ppre.train_lightglue(
        pdet, init_params=lightglue_state_from_jax(init), **kw)
    assert pmodel.cfg.descriptor_dim == dim and pmodel.cfg.depth == 1
    np.testing.assert_allclose([h["loss"] for h in phist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for key in ("precision", "recall"):
        assert [h[key] for h in phist] == [h[key] for h in jhist]


def test_train_lightglue_matches_jax(detectors):
    lightglue_case(detectors, "sp", 256)


def test_evaluate_matching_matches_jax(detectors):
    jdet, pdet = detectors["sp"]
    cfg = jlg.LightGlueConfig(depth=1)
    jmodel = jlg.LightGlue(cfg)
    zeros = (jnp.zeros((16, 2)), jnp.zeros((16, 256)), jnp.ones((16,), bool))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(4), *zeros, *zeros)
    kw = dict(n_pairs=3, h=48, w=48, n_kpts=16, seed=5)
    want = jpre.evaluate_matching(jdet, jitted(jmodel), variables, **kw)
    got = ppre.evaluate_matching(pdet, LightGlue(options_from_jax(cfg),
                                                 device="cpu"),
                                 lightglue_state_from_jax(variables), **kw)
    assert got == want and got["gt_matches"] > 0
