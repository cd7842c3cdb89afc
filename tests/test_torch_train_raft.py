"""RAFT training in the port against the JAX package, on the CPU.

The JAX state is ``create_train_state`` of the TINY configuration of
tests/test_checkpoint.py (under ``jax.jit``), with its biases, scales and
batch statistics perturbed by numpy so that none is trivial, carried over
by ``convert.train_state_from_jax``. Tolerances:
 - the train-mode forward's flows within 2e-5 px (measured 6e-6), the new
   batch statistics within 1e-5 + 1e-4 relative;
 - the loss and EPE of a step within 1e-5 relative;
 - gradients, read from the first moments after one step from zero moments
   (``mu = (1 - b1) * clipped g``; ``nu`` likewise holds ``g**2``): each
   leaf within 1e-3 of that leaf's largest value plus 1e-6 of the largest
   over all leaves. The second term is the floor for the convolution
   biases ahead of a batch norm in training mode, whose gradient is 0 up to
   rounding (~1e-9) on both sides;
 - parameters after a step within 1e-6 where |g| is above 1e-3 of its
   leaf's largest and above that floor. Elsewhere Adam's first step
   ``mu_hat / sqrt(nu_hat) = sign(g)`` turns rounding noise into +-lr;
 - the loss-function gradients against ``jax.grad`` within 1e-6 absolute.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_tracker_tpu.models import raft as jraft
from feature_tracker_tpu.train import raft_train as jrt
from feature_tracker_tpu_torch.convert import (
    options_from_jax,
    raft_state_from_jax,
    train_state_from_jax,
)
from feature_tracker_tpu_torch.models.raft import Raft
from feature_tracker_tpu_torch.train import optim
from feature_tracker_tpu_torch.train import raft_train as prt

TINY = jraft.RaftConfig(max_iterations=2, feature_channels=16,
                        context_channels=16, hidden_channels=8,
                        correlation_pyramid_levels=2, correlation_radius=1,
                        correlation_hidden_channels=8,
                        correlation_out_channels=4, flow_hidden_channels=4,
                        flow_out_channels=4, motion_out_channels=4,
                        mask_hidden_channels=8)
PTINY = options_from_jax(TINY)
SHAPE = (2, 32, 32, 1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port while a module of these runs: the
    suite runs several test files at once on the CPU, and more threads per
    file only wait on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def perturbed_jax_state(tcfg, seed=5):
    """``create_train_state`` with numpy-perturbed biases, scales and
    running statistics."""
    state = jax.jit(jrt.create_train_state, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), TINY, tcfg, SHAPE)
    rng = np.random.default_rng(seed)

    def stats(path, x):
        if path[-1].key == "mean":
            return jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)

    def params(path, x):
        if path[-1].key in ("bias", "scale"):
            return x + jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    return state.replace(
        params=jax.tree_util.tree_map_with_path(params, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(stats,
                                                     state.batch_stats))


def batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 255, (b, 32, 32, 1)).astype(np.float32)
    cur = rng.uniform(0, 255, (b, 32, 32, 1)).astype(np.float32)
    gt = rng.normal(0, 1, (b, 32, 32, 2)).astype(np.float32)
    return ref, cur, gt


def assert_step_close(port, jax_state):
    """A port state against a JAX state (or another port state), by the
    rules of the docstring."""
    want = (jax_state if isinstance(jax_state, prt.TrainState)
            else train_state_from_jax(jax_state, device="cpu"))
    assert int(port.step) == int(want.step)
    assert int(port.opt_state["count"]) == int(want.opt_state["count"])
    mu_max = max(float(v.abs().max()) for v in want.opt_state["mu"].values())
    floor = 1e-6 * mu_max
    for moment in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in want.opt_state[moment].values())
        for k, w in want.opt_state[moment].items():
            d = float((port.opt_state[moment][k] - w).abs().max())
            assert d <= 1e-3 * float(w.abs().max()) + 1e-6 * top, (moment, k)
    for k, w in want.params.items():
        g = want.opt_state["mu"][k].abs()
        sel = (g > 1e-3 * g.max()) & (g > floor)
        if sel.any():
            d = float((port.params[k] - w).abs()[sel].max())
            assert d <= 1e-6, (k, d)
    for k, w in want.batch_stats.items():
        np.testing.assert_allclose(port.batch_stats[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def supervised():
    """One supervised step on both sides from the same state."""
    tcfg = jrt.RaftTrainConfig()
    js = perturbed_jax_state(tcfg)
    ref, cur, gt = batch()
    js1, jm = jrt.make_train_step(TINY, tcfg)(js, ref, cur, gt)
    ps = train_state_from_jax(js, device="cpu")
    snapshot = copy.deepcopy(ps)
    ps1, pm = prt.make_train_step(PTINY, prt.RaftTrainConfig())(
        ps, ref, cur, gt)
    return js, ps, snapshot, (js1, jm), (ps1, pm)


def test_train_mode_forward_matches_flax(supervised):
    js = supervised[0]
    ref, cur, _ = batch()
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    flows, updates = jax.jit(
        lambda v, a, b: jraft.Raft(TINY).apply(
            v, a, b, train=True, mutable=["batch_stats"]))(variables, ref,
                                                           cur)
    model = Raft(PTINY, device="cpu")
    model.load_state_dict(raft_state_from_jax(variables))
    got, stats = model(torch.tensor(ref), torch.tensor(cur), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(flows),
                               rtol=0, atol=2e-5)
    want = train_state_from_jax(js.replace(
        batch_stats=updates["batch_stats"]), device="cpu").batch_stats
    assert list(stats) == list(want)
    for k in want:
        np.testing.assert_allclose(stats[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_batch_norm_running_variance_is_the_biased_one():
    """Flax's update (0.9 old + 0.1 biased variance), not torch's unbiased
    one: after one update of 100 values per channel the two differ by
    0.1 * var / 99."""
    from feature_tracker_tpu_torch.models.raft import BatchNorm
    x = torch.tensor(np.random.default_rng(1).normal(
        0, 1, (1, 10, 10, 3)).astype(np.float32))
    bn = BatchNorm(3)
    bn(x, train=True)
    flat = x.reshape(-1, 3).double()
    biased = ((flat * flat).mean(0) - flat.mean(0) ** 2)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               (0.1 * flat.mean(0)).numpy(), atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    torch_bn.train()(x.permute(0, 3, 1, 2))
    assert float((torch_bn.running_var - bn.running_var).abs().min()) > 1e-4


def test_one_supervised_step_matches_jax(supervised):
    _, _, _, (js1, jm), (ps1, pm) = supervised
    for key in ("loss", "epe"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-5)
    assert_step_close(ps1, js1)


def test_step_leaves_its_input_state_unchanged(supervised):
    _, ps, snapshot, _, _ = supervised
    assert all(torch.equal(a, b) for a, b in zip(ps.leaves(),
                                                 snapshot.leaves()))


# ------------------------------------------------------------- losses
def _np(t):
    return t.detach().numpy()


def test_sequence_loss_value_and_gradient():
    rng = np.random.default_rng(3)
    gt = rng.normal(0, 1, (2, 8, 8, 2)).astype(np.float32)
    preds = rng.normal(0, 1, (3, 2, 8, 8, 2)).astype(np.float32)
    preds[:, :, :4] = gt[None, :, :4]           # |diff| = 0: jnp.abs' tie
    jv, jg = jax.value_and_grad(lambda p: jrt.sequence_loss(p, gt, 0.8))(
        jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    v = prt.sequence_loss(p, torch.tensor(gt), 0.8)
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(p.grad), np.asarray(jg), atol=1e-6)
    assert float(p.grad[:, :, :4].abs().min()) > 0     # JAX's rule at 0


def test_warp_bilinear_with_ties_at_the_clip_bounds():
    rng = np.random.default_rng(4)
    h, w = 6, 7
    img = rng.uniform(0, 255, (2, h, w, 1)).astype(np.float32)
    flow = rng.normal(0, 2, (2, h, w, 2)).astype(np.float32)
    flow[:, :, 3, 0] = -3.0                          # x = 0 exactly
    flow[:, :, 0, 0] = np.float32(w - 1.001)         # x = w - 1.001 exactly
    flow[:, 2, :, 1] = -2.0                          # y = 0 exactly
    flow[:, 0, :, 1] = np.float32(h - 1.001)
    weights = rng.normal(0, 1, (2, h, w, 1)).astype(np.float32)

    def jloss(f):
        out, valid = jrt._warp_bilinear(jnp.asarray(img), f)
        return jnp.sum(out * weights) + jnp.sum(valid)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(flow))
    f = torch.tensor(flow, requires_grad=True)
    out, valid = prt._warp_bilinear(torch.tensor(img), f)
    v = torch.sum(out * torch.tensor(weights)) + torch.sum(valid)
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(f.grad), np.asarray(jg), atol=1e-4)
    np.testing.assert_array_equal(_np(valid), np.asarray(
        jrt._warp_bilinear(jnp.asarray(img), jnp.asarray(flow))[1]))
    # Half the gradient at the bounds (torch.clamp would pass all of it).
    x = torch.tensor([0.0, 2.0, 6.0 - 1.001], requires_grad=True)
    prt._clip(x, 0.0, 6.0 - 1.001).sum().backward()
    np.testing.assert_allclose(_np(x.grad), [0.5, 1.0, 0.5])


def test_edge_aware_smoothness_with_equal_neighbours():
    rng = np.random.default_rng(5)
    image = rng.uniform(0, 255, (2, 8, 9, 1)).astype(np.float32)
    flow = rng.normal(0, 1, (2, 8, 9, 2)).astype(np.float32)
    flow[:, 2:6, 2:6] = 0.5                          # |df| = 0 inside
    jv, jg = jax.value_and_grad(
        lambda f: jrt._edge_aware_smoothness(f, jnp.asarray(image)))(
        jnp.asarray(flow))
    f = torch.tensor(flow, requires_grad=True)
    v = prt._edge_aware_smoothness(f, torch.tensor(image))
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(f.grad), np.asarray(jg), atol=1e-6)


def test_photometric_sequence_loss_value_and_gradient():
    rng = np.random.default_rng(6)
    ref = rng.uniform(0, 255, (2, 10, 12, 1)).astype(np.float32)
    cur = np.roll(ref, 1, axis=2)
    preds = rng.normal(0, 1.5, (3, 2, 10, 12, 2)).astype(np.float32)
    preds[:, :, :, 5:8] = 1.0                        # equal neighbours
    jv, jg = jax.value_and_grad(lambda p: jrt.photometric_sequence_loss(
        p, jnp.asarray(ref), jnp.asarray(cur), 0.8))(jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    v = prt.photometric_sequence_loss(p, torch.tensor(ref), torch.tensor(cur),
                                      0.8)
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(p.grad), np.asarray(jg), atol=1e-6)


# ---------------------------------------------------------- optimizer
def _tree(rng, scale=1.0):
    return {"a.weight": torch.tensor(rng.normal(0, scale, (4, 3, 3, 3))),
            "a.bias": torch.tensor(rng.normal(0, scale, (4,))),
            "b.weight": torch.tensor(rng.normal(0, scale, (5, 4)))}


def _clip_optax_rule(grads, max_norm):
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def test_clip_adamw_matches_torch_adamw_in_float64():
    """Three steps in float64 against torch.optim.AdamW given the same
    clipped gradients (optax's rule): the update is the same function, in
    another order of operations."""
    rng = np.random.default_rng(7)
    params = _tree(rng)
    lr, wd, clip = 3e-3, 1e-2, 1.0
    tx = optim.ClipAdamW(lr, weight_decay=wd, clip_norm=clip)
    state = tx.init(params)
    ours = params
    theirs = {k: v.clone().requires_grad_() for k, v in params.items()}
    ref = torch.optim.AdamW(list(theirs.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=wd)
    for i in range(3):
        grads = _tree(rng, scale=0.5 if i != 1 else 0.01)  # one unclipped
        updates, state = tx.update(grads, state, ours)
        ours = optim.apply_updates(ours, updates)
        for k, p in theirs.items():
            p.grad = _clip_optax_rule(grads, clip)[k].clone()
        ref.step()
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].detach().numpy(),
                                   rtol=1e-12, atol=1e-15)
    assert int(state["count"]) == 3


@pytest.mark.parametrize("factor", [1 - 1e-6, 1 + 1e-6])
def test_clip_keeps_or_scales_at_the_norm(factor):
    """Just below max_norm the gradient passes unchanged; just above it is
    g / |g| * max_norm, with no epsilon (torch.nn.utils.clip_grad_norm_
    divides by |g| + 1e-6)."""
    rng = np.random.default_rng(8)
    grads = _tree(rng)
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    grads = {k: g / norm * 2.0 * factor for k, g in grads.items()}
    tx = optim.ClipAdamW(1.0, weight_decay=0.0, clip_norm=2.0, b1=0.0,
                         b2=0.0, eps=0.0)
    params = {k: torch.zeros_like(g) for k, g in grads.items()}
    # b1 = b2 = eps = 0: the update is -lr * clipped g / |clipped g|
    # elementwise, so read the clipped gradient from the first moment.
    _, state = tx.update(grads, tx.init(params), params)
    want = _clip_optax_rule(grads, 2.0)
    for k in grads:
        np.testing.assert_allclose(state["mu"][k].numpy(), want[k].numpy(),
                                   rtol=1e-15)
    assert (factor < 1) == all(torch.equal(state["mu"][k], grads[k])
                               for k in grads)


# ------------------------------------------------------ trainability
def test_raft_training_reduces_loss_on_constant_flow():
    """tests/test_raft.py's supervised trainability test on the port: a
    tiny RAFT fit to constant-shift pairs must reduce the sequence loss."""
    train_cfg = prt.RaftTrainConfig(learning_rate=1e-3)
    state = prt.create_train_state(0, PTINY, train_cfg, (2, 32, 32, 1),
                                   device="cpu")
    step = prt.make_train_step(PTINY, train_cfg)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (2, 40, 40)).astype(np.float32)
    ref = base[:, 4:36, 4:36, None]
    cur = base[:, 6:38, 4:36, None]  # shift dy = -2
    gt = np.broadcast_to(np.asarray([0.0, -2.0], np.float32), (2, 32, 32, 2))
    losses = []
    for _ in range(25):
        state, metrics = step(state, ref, cur, gt)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def test_unsup_train_step_improves_photometric_loss():
    """tests/test_raft.py's photometric trainability test on the port."""
    cfg = options_from_jax(jraft.RaftConfig(
        max_iterations=2, feature_channels=32, context_channels=32,
        hidden_channels=16, correlation_pyramid_levels=2,
        correlation_radius=2, correlation_hidden_channels=16,
        correlation_out_channels=8, flow_hidden_channels=8,
        flow_out_channels=4, motion_out_channels=8, mask_hidden_channels=16))
    tcfg = prt.RaftTrainConfig(learning_rate=1e-3)
    state = prt.create_train_state(0, cfg, tcfg, (2, 32, 32, 1),
                                   device="cpu")
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 255, (2, 32, 32, 1)).astype(np.float32)
    cur = np.roll(ref, 1, axis=2)
    step = prt.make_unsup_train_step(cfg, tcfg)
    losses = []
    for _ in range(4):
        state, m = step(state, ref, cur)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 1.5, losses


def test_create_train_state_draws_flax_initializers(supervised):
    """lecun_normal kernels (std 1/sqrt(fan_in), truncated at 2 std),
    zero biases, unit scales and variances, zero means and moments; the
    same seed gives the same state."""
    tcfg = prt.RaftTrainConfig()
    a = prt.create_train_state(3, PTINY, tcfg, SHAPE, device="cpu")
    b = prt.create_train_state(torch.Generator().manual_seed(3), PTINY, tcfg,
                               SHAPE, device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    w = a.params["context_enc.ResNetBlock_5.Conv_1.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert float(w.abs().max()) <= 2 / 0.8796256610342398 / np.sqrt(fan_in)
    assert list(a.params) == list(supervised[1].params)   # JAX's order
    for k, v in a.params.items():
        if k.endswith("bias"):
            assert not v.any()
    assert all(not v.any() for v in a.opt_state["mu"].values())
    assert all(float(v.min()) == 1.0 for k, v in a.batch_stats.items()
               if k.endswith("running_var"))


def test_row_bands_refuse_a_height_they_cannot_split():
    """A ``model`` axis splits H into 8-row units, at least one per rank:
    H % 8 != 0 and H / 8 < model raise when the step is called (JAX would
    split 16 rows over 4 devices; ROADMAP.md section 3), before any
    collective. An axis that is neither 'data' nor 'model' still raises
    when the step is made."""
    tcfg = prt.RaftTrainConfig()
    state = prt.create_train_state(0, PTINY, tcfg, None, device="cpu")
    for shape, h in (((1, 2), 36), ((1, 4), 24), ((2, 3), 16)):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=shape)
        ref, cur, gt = (np.zeros((2, h, 32, c), np.float32)
                        for c in (1, 1, 2))
        with pytest.raises(ValueError, match=f"H = {h} does not split"):
            prt.make_train_step(PTINY, tcfg, mesh)(state, ref, cur, gt)
        with pytest.raises(ValueError, match=f"H = {h} does not split"):
            prt.make_unsup_train_step(PTINY, tcfg, mesh=mesh)(state, ref,
                                                               cur)
    other = types.SimpleNamespace(mesh_dim_names=("data", "space"),
                                  shape=(1, 2))
    with pytest.raises(ValueError, match="'space'"):
        prt.make_train_step(PTINY, tcfg, other)
    with pytest.raises(ValueError, match="'space'"):
        prt.make_unsup_train_step(PTINY, tcfg, mesh=other)
