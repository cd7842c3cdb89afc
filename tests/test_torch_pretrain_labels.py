"""The pools of the port's SuperPoint adaptation with DISK labels
(``adapt_superpoint``'s ``disk``, ``disk_dense`` and ``disk_topk``
labelers) and of ``distill_superpoint_from_disk`` (DISK labels and the
teacher's targets) against the JAX package's, on the CPU, bit for bit but
for the targets (within float32 rounding).
"""

import pytest

from feature_tracker_tpu.models import superpoint as jsp
from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu_torch.convert import (
    options_from_jax,
    superpoint_state_from_jax,
)
from feature_tracker_tpu_torch.models.superpoint import SuperPoint
from feature_tracker_tpu_torch.train import pretrain as ppre

from test_torch_pretrain import BATCH, HW, SP
from test_torch_pretrain_stages import assert_pools_equal, capture_pools
from test_torch_pretrain_steps import jax_sp_variables
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


@pytest.mark.parametrize("labeler", ["disk", "disk_dense", "disk_topk"])
def test_adapt_superpoint_disk_pools_are_jax_data(monkeypatch, labeler):
    """The DISK labelers' pools (no step taken)."""
    pools = capture_pools(monkeypatch)
    jmodel, variables = jax_sp_variables()
    kw = dict(rounds=1, steps=0, h=HW, w=HW, batch=BATCH, pool_size=5,
              labeler=labeler, n_warps=3)
    jpre.adapt_superpoint(jmodel, variables, **kw)
    ppre.adapt_superpoint(SuperPoint(options_from_jax(SP), device="cpu"),
                          superpoint_state_from_jax(variables), **kw)
    assert_pools_equal(pools)
    with pytest.raises(ValueError, match="unknown labeler"):
        ppre.adapt_superpoint(SuperPoint(options_from_jax(SP), device="cpu"),
                              None, labeler="sift")


def test_distill_superpoint_matches_jax(monkeypatch):
    """The distillation pool: DISK labels, the teacher's targets (within
    float32 rounding) and the generator's draws (its step is held above,
    its loop is adapt_superpoint's)."""
    pools = capture_pools(monkeypatch)
    cfg = jsp.SuperPointConfig()
    jmodel, variables = jax_sp_variables(cfg, seed=5)
    kw = dict(steps=0, h=HW, w=HW, batch=BATCH, pool_size=3, n_warps=3,
              n_extra_pts=6)
    jpre.distill_superpoint_from_disk(jmodel, variables, **kw)
    ppre.distill_superpoint_from_disk(
        SuperPoint(options_from_jax(cfg), device="cpu"),
        superpoint_state_from_jax(variables), **kw)
    assert_pools_equal(pools, float_atol=1e-5)
