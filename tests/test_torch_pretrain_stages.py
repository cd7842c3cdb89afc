"""The SuperPoint stages of the port's pretraining driver
(``train/pretrain.py``) against the JAX package's, on the CPU:
``adapt_superpoint`` end to end with Harris labels (pools and losses) and
``train_superpoint``'s pool and batch order (their steps are held in
tests/test_torch_pretrain_steps.py, the DISK labelers' pools in
tests/test_torch_pretrain_labels.py).
"""

import numpy as np

from feature_tracker_tpu.train import pretrain as jpre
from feature_tracker_tpu_torch.convert import (
    options_from_jax,
    superpoint_state_from_jax,
)
from feature_tracker_tpu_torch.models.superpoint import SuperPoint
from feature_tracker_tpu_torch.train import pretrain as ppre

from test_torch_pretrain import BATCH, HW, SP
from test_torch_pretrain_steps import jax_sp_variables
from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)


def capture_pools(monkeypatch):
    """Record the pool each package's ``_sp_train_loop`` is given."""
    pools = {"jax": [], "port": []}
    for name, module in (("jax", jpre), ("port", ppre)):
        loop = module._sp_train_loop

        def record(step, params, opt_state, pool, *args, _loop=loop,
                   _name=name):
            pools[_name].append(pool)
            return _loop(step, params, opt_state, pool, *args)

        monkeypatch.setattr(module, "_sp_train_loop", record)
    return pools


def assert_pools_equal(pools, float_atol=None):
    assert len(pools["jax"]) == len(pools["port"]) > 0
    for jpool, ppool in zip(pools["jax"], pools["port"]):
        assert len(jpool) == len(ppool) > 0
        for jentry, pentry in zip(jpool, ppool):
            assert len(jentry) == len(pentry)
            for i, (w, g) in enumerate(zip(jentry, pentry)):
                if float_atol is not None and i >= 7:   # teacher targets
                    np.testing.assert_allclose(g, w, rtol=0, atol=float_atol)
                else:
                    np.testing.assert_array_equal(np.asarray(g),
                                                  np.asarray(w))


def histories_close(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for key in ("loss", "det", "desc"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-5,
                                   err_msg=key)


def test_adapt_superpoint_matches_jax(monkeypatch):
    """Harris labels, point descriptors, wide-scale warps: the pool and
    three steps (two rounds, each from a fresh optimizer) as JAX's."""
    pools = capture_pools(monkeypatch)
    jmodel, variables = jax_sp_variables(seed=4)
    kw = dict(rounds=2, steps=2, h=HW, w=HW, batch=BATCH, pool_size=5,
              log_every=1, point_desc=True, wide_scale=True, n_warps=4)
    jparams, jhist = jpre.adapt_superpoint(jmodel, variables, **kw)
    pmodel = SuperPoint(options_from_jax(SP), device="cpu")
    pparams, phist = ppre.adapt_superpoint(
        pmodel, {k: v for k, v in superpoint_state_from_jax(
            variables).items() if not k.endswith("num_batches_tracked")},
        **kw)
    assert_pools_equal(pools)
    histories_close(phist, jhist)
    assert [h["round"] for h in phist] == [0, 0, 1, 1]


def test_train_superpoint_pool_is_jax_data(monkeypatch):
    """The pool and batch order of ``train_superpoint`` (the weights start
    from each package's own initializers)."""
    pools = capture_pools(monkeypatch)
    for module in (jpre, ppre):
        monkeypatch.setattr(module, "_make_sp_step", lambda *a, **k: None)
    orders = {}

    def no_training(name):
        def loop(step, params, opt_state, pool, steps, rng, *args):
            pools[name].append(pool)
            orders[name] = (rng.permutation(len(pool)), rng.uniform())
            return params, opt_state, []
        return loop

    monkeypatch.setattr(jpre, "_sp_train_loop", no_training("jax"))
    monkeypatch.setattr(ppre, "_sp_train_loop", no_training("port"))
    jpre.train_superpoint(steps=2, h=HW, w=40, batch=3)
    ppre.train_superpoint(steps=2, h=HW, w=40, batch=3, device="cpu")
    assert_pools_equal(pools)
    assert len(pools["port"][0]) == 6
    np.testing.assert_array_equal(orders["port"][0], orders["jax"][0])
    assert orders["port"][1] == orders["jax"][1]
