"""The port's CheckpointManager: tests/test_checkpoint.py's four tests on
the port (save -> restore round trip, resume continues the identical
trajectory, retention, restore without a checkpoint), Orbax's saving rules,
and the weight file of a port-trained RAFT state read by the JAX package.

The resumed trajectory is bit-equal here (the CPU step is deterministic);
JAX's own test allows 1e-6 / 1e-7. The weight file's flows agree with the
port's within 3e-6 px (the inference parity of tests/test_torch_raft.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import raft as jraft
from feature_tracker_tpu.utils.weights import load_pytree
from feature_tracker_tpu_torch.convert import options_from_jax
from feature_tracker_tpu_torch.models.raft import Raft
from feature_tracker_tpu_torch.train.checkpoint import CheckpointManager
from feature_tracker_tpu_torch.train.raft_pretrain import jax_variables
from feature_tracker_tpu_torch.train.raft_train import (
    RaftTrainConfig,
    create_train_state,
    make_train_step,
)
from feature_tracker_tpu_torch.utils.weights import save_pytree

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

TINY = jraft.RaftConfig(max_iterations=2, feature_channels=16,
                        context_channels=16, hidden_channels=8,
                        correlation_pyramid_levels=2, correlation_radius=1,
                        correlation_hidden_channels=8,
                        correlation_out_channels=4, flow_hidden_channels=4,
                        flow_out_channels=4, motion_out_channels=4,
                        mask_hidden_channels=8)
PTINY = options_from_jax(TINY)


@pytest.fixture(scope="module")
def setup():
    train_cfg = RaftTrainConfig()
    state = create_train_state(0, PTINY, train_cfg, (1, 32, 32, 1),
                               device="cpu")
    step = make_train_step(PTINY, train_cfg)
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 255, (1, 32, 32, 1)).astype(np.float32)
    cur = rng.uniform(0, 255, (1, 32, 32, 1)).astype(np.float32)
    gt = rng.normal(0, 1, (1, 32, 32, 2)).astype(np.float32)
    return state, step, (ref, cur, gt)


def test_save_restore_round_trip(setup, tmp_path):
    state, step_fn, batch = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state1, _ = step_fn(state, *batch)
    assert mgr.save(int(state1.step), state1)
    restored = mgr.restore(state)
    assert all(torch.equal(a, b) for a, b in zip(restored.leaves(),
                                                 state1.leaves()))
    assert list(restored.params) == list(state1.params)
    assert int(restored.step) == int(state1.step)
    mgr.close()


def test_resume_continues_identical_trajectory(setup, tmp_path):
    state, step_fn, batch = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt2"))
    s1, _ = step_fn(state, *batch)
    mgr.save(int(s1.step), s1)
    s2_direct, m_direct = step_fn(s1, *batch)

    resumed = mgr.restore(s1)
    s2_resumed, m_resumed = step_fn(resumed, *batch)
    assert float(m_direct["loss"]) == float(m_resumed["loss"])
    assert all(torch.equal(a, b) for a, b in zip(s2_direct.leaves(),
                                                 s2_resumed.leaves()))
    mgr.close()


def test_retention_keeps_max_to_keep(setup, tmp_path):
    state, step_fn, batch = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt3"), max_to_keep=2)
    s = state
    for _ in range(4):
        s, _ = step_fn(s, *batch)
        mgr.save(int(s.step), s)
    steps = mgr.all_steps()
    assert len(steps) == 2
    assert mgr.latest_step() == int(s.step)
    mgr.close()


def test_restore_missing_raises(tmp_path, setup):
    state, _, _ = setup
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=3)
    mgr.close()


def test_orbax_saving_rules(setup, tmp_path):
    """Orbax's rules, as probed on it (max_to_keep=2, save_interval_steps=2,
    saves at steps 1-6): the first save always happens, then only steps
    that are multiples of the interval, never a step at or before the
    latest; [4, 6] are kept."""
    state, _, _ = setup
    mgr = CheckpointManager(str(tmp_path / "rules"), max_to_keep=2,
                            save_interval_steps=2)
    saved = [mgr.save(s, state) for s in range(1, 7)]
    assert saved == [True, True, False, True, False, True]
    assert mgr.all_steps() == [4, 6]
    assert not mgr.save(6, state)          # re-saving the latest
    assert not mgr.save(2, state)          # an older step
    assert mgr.all_steps() == [4, 6]
    # A new manager over the same directory has saved before.
    again = CheckpointManager(str(tmp_path / "rules"), max_to_keep=2,
                              save_interval_steps=2)
    assert not again.save(7, state) and again.save(8, state)
    assert again.all_steps() == [6, 8]
    assert not any(".tmp" in name for name in os.listdir(tmp_path / "rules"))


def test_restore_places_on_the_template_and_checks_it(setup, tmp_path):
    state, step_fn, batch = setup
    mgr = CheckpointManager(str(tmp_path / "place"))
    mgr.save(1, step_fn(state, *batch)[0])
    like = state.replace(params={k: v.double()
                                 for k, v in state.params.items()})
    restored = mgr.restore(like)
    assert all(v.dtype == torch.float64 for v in restored.params.values())
    bad = state.replace(params=dict(list(state.params.items())[1:]))
    with pytest.raises(ValueError, match="params"):
        mgr.restore(bad)


def test_port_trained_weights_run_in_the_jax_model(setup, tmp_path):
    """save_pytree of a port-trained state in JAX's layout: JAX's
    load_pytree reads it into its own variables tree, and JAX's Raft runs
    it to the port's flows."""
    state, step_fn, batch = setup
    for _ in range(2):
        state, _ = step_fn(state, *batch)
    path = str(tmp_path / "raft_tiny.npz")
    save_pytree(path, jax_variables(state.params, state.batch_stats))
    ref, cur, _ = batch
    like = jax.jit(lambda k: jraft.Raft(TINY).init(k, ref, cur))(
        jax.random.PRNGKey(1))
    variables = load_pytree(path, like)
    want = jax.jit(lambda v: jraft.Raft(TINY).apply(v, ref, cur))(variables)
    model = Raft(PTINY, device="cpu")
    model.load_state_dict({**state.params, **state.batch_stats}, strict=False)
    got = model(ref, cur)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-6)
    assert not np.array_equal(np.asarray(jax.tree_util.tree_leaves(
        variables)[0]), np.asarray(jax.tree_util.tree_leaves(like)[0]))


def test_raft_pretrain_main_writes_only_its_weights_dir(tmp_path, monkeypatch):
    """``raft_pretrain.main`` with ``WEIGHTS_DIR`` pointed at a temporary
    directory: it prints its held-out line, writes the compact model in
    JAX's layout and the metrics there (no EPE recorded yet, so the gate
    passes), keeps them when a second run at another resolution is
    gate-rejected, and leaves the repository's ``weights/`` as it was."""
    import hashlib
    import json

    from feature_tracker_tpu_torch.train import raft_pretrain
    from feature_tracker_tpu_torch.utils.weights import (
        WEIGHTS_DIR,
        load_raft_npz,
    )

    def digest():
        return {name: hashlib.sha256(open(os.path.join(WEIGHTS_DIR, name),
                                          "rb").read()).hexdigest()
                for name in sorted(os.listdir(WEIGHTS_DIR))}

    before = digest()
    monkeypatch.setattr(raft_pretrain, "WEIGHTS_DIR", str(tmp_path))
    kw = dict(steps=2, batch=2, iters=2, eval_pairs=2, small=1, log_every=1,
              device="cpu")
    agg = raft_pretrain.main(h=32, w=32, **kw)
    assert sorted(os.listdir(tmp_path)) == ["metrics.json", "raft_small.npz"]
    assert json.load(open(tmp_path / "metrics.json"))["raft_small"] == agg
    cfg = raft_pretrain.RaftConfig(
        max_iterations=2, feature_channels=64, context_channels=64,
        hidden_channels=32, correlation_pyramid_levels=2,
        correlation_radius=3, correlation_hidden_channels=32,
        correlation_out_channels=16, flow_hidden_channels=16,
        flow_out_channels=8, motion_out_channels=16, mask_hidden_channels=32)
    load_raft_npz(str(tmp_path / "raft_small.npz"), cfg)
    written = (tmp_path / "raft_small.npz").read_bytes()
    raft_pretrain.main(h=40, w=40, **kw)       # another resolution: kept
    assert (tmp_path / "raft_small.npz").read_bytes() == written
    assert digest() == before
