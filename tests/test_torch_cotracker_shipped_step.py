"""CoTracker's train step at the shipped run's configuration
(``weights/metrics.json["cotracker"]``: feature 96, model 192, depth 3, four
iterations) from ``weights/cotracker.npz``, on the CPU, through the JAX
package and the port, on one clip of 8 x 32x32 with 8 points.

At this width the flow embedding's top frequencies reach 2^47
(models/cotracker.py), and the gradients that cross it from one refinement
iteration to the next grow until their global norm overflows float32:
``clip_by_global_norm`` scales every gradient to 0, and the step leaves
both Adam moments at exactly 0 in every leaf. JAX's step does so (its
global norm is read through an optax transformation chained ahead of the
clip) and the port's alike, and the losses agree within 1e-5 relative.
Starting from Flax's initializers with the heads drawn N(0, 0.05), as the
small configuration's tests do to reach every leaf, does not avoid it at
this width: the port's global norm is not finite there either.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from feature_tracker_tpu.models import cotracker as jcot
from feature_tracker_tpu.train import cotracker_pretrain as jcp
from feature_tracker_tpu.utils.weights import load_pytree
from feature_tracker_tpu_torch.models.cotracker import CoTracker
from feature_tracker_tpu_torch.models.layers import flax_order
from feature_tracker_tpu_torch.train import cotracker_pretrain as pcp
from feature_tracker_tpu_torch.train import optim as poptim
from feature_tracker_tpu_torch.utils.weights import (
    load_cotracker_npz,
    shipped_cotracker_config,
    weights_path,
)

from test_torch_train_raft import few_threads  # noqa: F401 (a fixture)

T, H, W, N = 8, 32, 32, 8


def global_norm_stash():
    """An optax transformation that passes the gradients on and keeps
    their global norm as its state."""
    return optax.GradientTransformation(
        lambda params: jnp.zeros(()),
        lambda grads, state, params=None: (grads, optax.global_norm(grads)))


class NormStash(poptim.ClipAdamW):
    """The port's optimizer, keeping the global norm of the gradients it
    was last given."""

    def update(self, grads, opt_state, params):
        g = poptim._flat(grads).detach()
        self.norm = torch.sqrt(torch.sum(g * g))
        return super().update(grads, opt_state, params)


def test_shipped_step_clips_every_gradient_to_zero_in_jax_and_port():
    with open(weights_path("metrics.json")) as fh:
        jcfg = jcot.CoTrackerConfig(**json.load(fh)["cotracker"]["config"])
    model = jcot.CoTracker(jcfg)
    like = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       jnp.zeros((T, H, W, 1)), jnp.zeros((N, 2))))
    params = load_pytree(weights_path("cotracker.npz"),
                         {"params": like["params"]})["params"]
    # The shipped run's schedule (metrics.json: peak 1e-4, 3000 steps,
    # warmup 500) and optax.adamw's default decay.
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-4, 500, 3000, 1e-6)
    tx = optax.chain(global_norm_stash(), optax.clip_by_global_norm(1.0),
                     optax.adamw(sched))
    batch = jcp.make_pool(np.random.default_rng(11), 1, 1, T, H, W, N,
                          wide_motion=True)[0]
    _, _, jopt, jloss, _ = jcp.make_train_step(model, tx)(
        params, params, tx.init(params), *batch)
    adam = jopt[2][0]
    assert not np.isfinite(float(jopt[0]))
    for leaf in jax.tree_util.tree_leaves((adam.mu, adam.nu)):
        assert not np.asarray(leaf).any()

    cfg = shipped_cotracker_config()
    state = flax_order(load_cotracker_npz(weights_path("cotracker.npz"), cfg))
    ptx = NormStash(poptim.warmup_cosine_schedule(
        1e-4, 500, 3000, init_value=0.0, end_value=1e-6), weight_decay=1e-4)
    _, _, popt, ploss, _ = pcp.make_train_step(
        CoTracker(cfg, device="cpu"), ptx)(
            state, state, ptx.init(state), *(np.asarray(a) for a in batch))
    assert not bool(torch.isfinite(ptx.norm))
    for moment in ("mu", "nu"):
        assert list(popt[moment]) == list(state)
        for k, v in popt[moment].items():
            assert not bool(v.any()), (moment, k)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)


def test_perturbed_heads_do_not_avoid_it_at_the_shipped_width():
    cfg = shipped_cotracker_config()
    model = CoTracker(cfg, device="cpu")
    rng = np.random.default_rng(9)
    state = {k: (torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape))
                                  .astype(np.float32))
                 if k.startswith(("update.delta_head.", "update.vis_head."))
                 else v) for k, v in pcp.init_params(model, 0).items()}
    ptx = NormStash(1e-4, weight_decay=1e-4)
    batch = pcp.make_pool(np.random.default_rng(11), 1, 1, T, H, W, N,
                          wide_motion=True, device="cpu")[0]
    pcp.make_train_step(model, ptx)(state, state, ptx.init(state), *batch)
    assert not bool(torch.isfinite(ptx.norm))
