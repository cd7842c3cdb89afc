"""The trainers' optimizer: optax's
``chain(clip_by_global_norm(clip_norm), adamw(learning_rate,
weight_decay=weight_decay))``, which every JAX trainer builds, as a pure
function of tensors. The JAX package has no module of this name; it calls
optax.

``ClipAdamW`` keeps optax's ``GradientTransformation`` contract:
``init(params)`` gives the state and ``update(grads, opt_state, params)``
returns ``(updates, new_opt_state)``; :func:`apply_updates` adds the
updates. Parameters, gradients, updates and the moments are dicts of
tensors (``state_dict`` keys, in the order JAX flattens the Flax tree);
nothing passed in is modified, and each result is a dict of views of one
new flat tensor, so one step costs a few kernel launches whatever the
number of leaves. The state is ``{"count": int32 0-dim, "mu": ..., "nu":
...}``: optax's ``ScaleByAdamState`` (a schedule's own count always equals
``count``).

Where torch's own optimizer differs, this follows optax:
 - clipping: ``g`` is kept when ``|g| < max_norm`` and is
   ``g / |g| * max_norm`` otherwise, with no epsilon
   (``torch.nn.utils.clip_grad_norm_`` scales by
   ``max_norm / (|g| + 1e-6)``);
 - AdamW: ``mu`` and ``nu`` first, bias correction by ``count + 1``,
   ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p``, then
   ``p - lr(count) * u`` (``torch.optim.AdamW`` decays ``p`` before the
   step and updates in place);
 - the learning rate is evaluated at the count before the update, so a
   schedule that warms up from 0 leaves the parameters unchanged at the
   first step.
"""

from __future__ import annotations

import math

import torch

from feature_tracker_tpu_torch.models.layers import divide


def _flat(tree: dict) -> torch.Tensor:
    """A new flat float tensor of the leaves, in the dict's order."""
    return torch.cat([t.reshape(-1) for t in tree.values()])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    """``like``'s keys and shapes as views of ``flat``."""
    sizes = [t.numel() for t in like.values()]
    return {k: v.view(t.shape) for (k, t), v in
            zip(like.items(), flat.split(sizes))}


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           total_steps: int, init_value: float = 0.0,
                           end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule(init_value, peak,
    warmup_steps, total_steps, end_value)``: ``join_schedules(
    [linear_schedule(init_value, peak, warmup_steps),
    cosine_decay_schedule(peak, total_steps - warmup_steps, alpha=end_value
    / peak)], [warmup_steps])``: the learning rate (float32, on ``count``'s
    device) of an int32 0-dim ``count``, in optax's float32 arithmetic."""
    decay_steps = total_steps - warmup_steps
    alpha = 0.0 if peak == 0.0 else end_value / peak

    def schedule(count: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(count, 0, warmup_steps).float()
        frac = 1 - divide(warm, float(warmup_steps))
        linear = (init_value - peak) * frac + peak
        since = torch.clamp(count - warmup_steps, max=decay_steps).float()
        cosine = 0.5 * (1 + torch.cos(divide(math.pi * since,
                                             float(decay_steps))))
        decayed = (1 - alpha) * cosine + alpha
        return torch.where(count < warmup_steps, linear, peak * decayed)

    return schedule


class ClipAdamW:
    """Global-norm clipping, then AdamW, as optax chains them (see the
    module docstring). ``learning_rate`` is a float or a schedule (a
    function of the int32 count tensor, such as
    :func:`warmup_cosine_schedule`)."""

    def __init__(self, learning_rate, weight_decay: float = 1e-4,
                 clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> dict:
        zeros = torch.zeros_like(_flat(params))
        first = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                "mu": _unflat(zeros, params),
                "nu": _unflat(zeros.clone(), params)}

    def lr(self, count: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """The learning rate at ``count`` (0-dim, on its device): a constant
        one in ``dtype``, as optax scales by a Python float; a schedule's in
        float32, as optax computes it, then cast."""
        if callable(self.learning_rate):
            return self.learning_rate(count).to(dtype)
        return torch.full((), self.learning_rate, dtype=dtype,
                          device=count.device)

    def update(self, grads: dict, opt_state: dict, params: dict):
        b1, b2 = self.b1, self.b2
        g = _flat(grads).detach()
        p = _flat(params).detach()
        # clip_by_global_norm: lax.select(|g| < max_norm, g,
        # (g / |g|) * max_norm).
        norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(norm < self.clip_norm, g, (g / norm) * self.clip_norm)
        # scale_by_adam (eps_root 0).
        mu = (1 - b1) * g + b1 * _flat(opt_state["mu"])
        nu = (1 - b2) * (g * g) + b2 * _flat(opt_state["nu"])
        count = opt_state["count"]
        count_inc = count + 1
        mu_hat = mu / (1 - b1 ** count_inc.to(p.dtype))
        nu_hat = nu / (1 - b2 ** count_inc.to(p.dtype))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        # add_decayed_weights, then scale_by_learning_rate.
        u = u + self.weight_decay * p
        u = -self.lr(count, p.dtype) * u
        return _unflat(u, params), {"count": count_inc,
                                    "mu": _unflat(mu, params),
                                    "nu": _unflat(nu, params)}


def apply_updates(params: dict, updates: dict) -> dict:
    """optax's ``apply_updates``: ``p + u`` for every leaf, as views of one
    new flat tensor."""
    return _unflat(_flat(params).detach() + _flat(updates), params)


def value_and_grad(loss_fn, params: dict):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` for a dict of
    tensors: ``loss_fn(params)`` returns ``(loss, aux)``; the result is
    ``(loss, aux, grads)``, detached, with the gradients as views of one
    flat tensor. ``params`` themselves are not touched."""
    flat = _flat(params).detach().requires_grad_()
    loss, aux = loss_fn(_unflat(flat, params))
    (grad,) = torch.autograd.grad(loss, flat)
    return loss.detach(), aux, _unflat(grad, params)
