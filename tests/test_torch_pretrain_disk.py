"""The DISK stages of the port's pretraining driver (``train/pretrain.py``)
against the JAX package's, on the CPU: ``train_disk`` and
``train_lightglue`` on DISK's 128-wide descriptors, three steps each from
JAX's ``init`` state (losses within 1e-5 relative, LightGlue's match
statistics equal).
"""

import jax
import jax.numpy as jnp
import numpy as np

from feature_tracker_tpu.models import disk as jdisk
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu_torch.convert import disk_state_from_jax
from feature_tracker_tpu_torch.train import pretrain as ppre

from test_torch_pretrain import HW, detectors  # noqa: F401 (a fixture)
from test_torch_pretrain_matchers import lightglue_case
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


def test_train_disk_matches_jax():
    model = jdisk.Disk(jdisk.DiskConfig())
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, HW, HW, 1), jnp.float32))
    kw = dict(steps=3, h=HW, w=HW, seed=2, log_every=1, hinge_weight=0.5,
              lr=1e-3)
    _, _, jhist = jpre.train_disk(init_params=variables, **kw)
    _, params, phist = ppre.train_disk(
        init_params=disk_state_from_jax(variables), device="cpu", **kw)
    np.testing.assert_allclose([h["loss"] for h in phist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert list(params) == list(disk_state_from_jax(variables))


def test_train_lightglue_on_disk_matches_jax(detectors):
    lightglue_case(detectors, "disk", 128)
