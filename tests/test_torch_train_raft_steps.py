"""More RAFT train steps of the port against the JAX package, on the CPU:
the unsupervised (photometric) step, the supervised step with
``low_memory=True`` (the on-the-fly lookup, differentiable on the CPU), and
three steps under the warm-up and cosine schedule.

Each starts from a JAX ``TrainState`` built by JAX's own optimizer from a
port-initialised state carried to the Flax layout
(``raft_pretrain.jax_variables``), which spares JAX's model.init compile.
Tolerances are those of tests/test_torch_train_raft.py
(``assert_step_close``); the scheduled losses within 1e-4 relative and the
learning rate of each count within 1e-6 relative of optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_tracker_tpu.models import raft as jraft
from feature_tracker_tpu.train import raft_train as jrt
from feature_tracker_tpu_torch.convert import (
    options_from_jax,
    train_state_from_jax,
)
from feature_tracker_tpu_torch.train import raft_train as prt
from feature_tracker_tpu_torch.train.raft_pretrain import jax_variables

from test_torch_train_raft import (  # noqa: F401 (a fixture)
    TINY,
    assert_step_close,
    batch,
    few_threads,
)


def jax_state(jcfg, tcfg, seed=0):
    """A JAX TrainState from a port state of ``jcfg`` with perturbed
    statistics and biases, and JAX's optimizer state for it."""
    port = prt.create_train_state(seed, options_from_jax(jcfg),
                                  prt.RaftTrainConfig(**vars(tcfg)), None,
                                  device="cpu")
    rng = np.random.default_rng(seed + 1)
    params = {k: v + torch.tensor(rng.normal(0, 0.05, v.shape),
                                  dtype=torch.float32)
              if k.endswith("bias") or v.ndim == 1 else v
              for k, v in port.params.items()}
    stats = {k: torch.tensor(rng.normal(0, 0.1, v.shape) if "mean" in k
                             else rng.uniform(0.5, 1.5, v.shape),
                             dtype=torch.float32)
             for k, v in port.batch_stats.items()}
    tree = jax.tree_util.tree_map(jnp.asarray, jax_variables(params, stats))
    return jrt.TrainState(
        step=jnp.zeros((), jnp.int32), params=tree["params"],
        batch_stats=tree["batch_stats"],
        opt_state=jrt.make_optimizer(tcfg).init(tree["params"]))


def test_one_unsupervised_step_matches_jax():
    tcfg = jrt.RaftTrainConfig()
    js = jax_state(TINY, tcfg)
    ps = train_state_from_jax(js, device="cpu")
    rng = np.random.default_rng(1)
    ref = rng.uniform(0, 255, (2, 32, 32, 1)).astype(np.float32)
    cur = np.roll(ref, 1, axis=2)
    js1, jm = jrt.make_unsup_train_step(TINY, tcfg)(js, ref, cur)
    ps1, pm = prt.make_unsup_train_step(
        options_from_jax(TINY), prt.RaftTrainConfig())(ps, ref, cur)
    for key in ("loss", "mean_flow"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5)
    assert_step_close(ps1, js1)


def test_low_memory_supervised_step_matches_jax():
    """train=True with low_memory on the CPU: the plain on-the-fly lookup
    is differentiable and gives JAX's step (on the card it raises)."""
    jcfg = jraft.RaftConfig(**{**vars(TINY), "low_memory": True})
    tcfg = jrt.RaftTrainConfig()
    js = jax_state(jcfg, tcfg, seed=2)
    ps = train_state_from_jax(js, device="cpu")
    ref, cur, gt = batch(seed=3)
    js1, jm = jrt.make_train_step(jcfg, tcfg)(js, ref, cur, gt)
    ps1, pm = prt.make_train_step(options_from_jax(jcfg),
                                  prt.RaftTrainConfig())(ps, ref, cur, gt)
    for key in ("loss", "epe"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5)
    assert_step_close(ps1, js1)


def test_three_scheduled_steps_match_jax():
    tcfg = jrt.RaftTrainConfig(schedule_steps=10, warmup_frac=0.2)
    ptcfg = prt.RaftTrainConfig(**vars(tcfg))
    js = jax_state(TINY, tcfg, seed=4)
    ps = train_state_from_jax(js, device="cpu")
    jstep = jrt.make_train_step(TINY, tcfg)
    pstep = prt.make_train_step(options_from_jax(TINY), ptcfg)
    for i in range(3):
        ref, cur, gt = batch(seed=10 + i)
        js, jm = jstep(js, ref, cur, gt)
        ps, pm = pstep(ps, ref, cur, gt)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(ps.step) == int(ps.opt_state["count"]) == 3
    # The schedule: optax's, evaluated at the count before each update.
    warm = max(1, int(tcfg.schedule_steps * tcfg.warmup_frac))
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, tcfg.learning_rate, warm),
         optax.cosine_decay_schedule(tcfg.learning_rate,
                                     tcfg.schedule_steps - warm)], [warm])
    tx = prt.make_optimizer(ptcfg)
    for count in range(14):
        got = float(tx.lr(torch.tensor(count, dtype=torch.int32)))
        np.testing.assert_allclose(got, float(want(jnp.int32(count))),
                                   rtol=1e-6, atol=0)
    assert float(tx.lr(torch.tensor(0, dtype=torch.int32))) == 0.0


def test_train_state_from_jax_reads_the_optax_counts():
    tcfg = jrt.RaftTrainConfig(schedule_steps=10)
    js = jax_state(TINY, tcfg, seed=5)
    clip, (adam, decay, sched) = js.opt_state
    state = train_state_from_jax(js.replace(
        step=jnp.int32(7), opt_state=(clip, (adam._replace(
            count=jnp.int32(7)), decay, sched._replace(count=jnp.int32(7))))),
        device="cpu")
    assert int(state.step) == int(state.opt_state["count"]) == 7
    with pytest.raises(ValueError, match="schedule's count"):
        train_state_from_jax(js.replace(opt_state=(clip, (
            adam, decay, sched._replace(count=jnp.int32(3))))), device="cpu")
