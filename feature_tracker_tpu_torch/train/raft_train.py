"""RAFT supervised and unsupervised training — the counterpart of
``feature_tracker_tpu/train/raft_train.py``.

The standard RAFT sequence loss (exponentially weighted L1 over the
per-iteration predictions, gamma = 0.8), or the photometric-warp loss for
pairs without ground truth, with global-norm clipping and AdamW
(``train/optim.py``, optax's rules), as a pure train step: the
``TrainState`` passed in is left as it was and a new one is returned.

The step evaluates ``Raft(cfg)(ref, cur, train=True)`` with
``torch.func.functional_call`` over the state's tensors, in full float32
(TF32 off for the forward and the backward). Gradient rules at ties are
JAX's: ``jnp.clip`` (``minimum(maximum(.))``) passes half the gradient at
its bounds and ``jnp.abs`` passes 1 at 0, where ``torch.clamp`` passes 1
and ``torch.abs`` 0.

Data parallel: with a mesh, every rank is given the whole batch and keeps
its slice of the batch axis (the ``data`` axis; ``shard_features``'s
slices), batch normalisation sums its statistics over the ranks, the
loss and the metrics are those of the whole batch, and the gradient is
all-reduced once per step, so the result is the one-rank step's on the
whole batch, as under JAX's ``jit`` with the batch sharded. Height
sharding over a ``model`` axis (which needs halo exchanges in every
convolution) is not ported: a mesh with ``model`` larger than 1 raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import (
    abs_like_jax as _abs,
    clip_like_jax as _clip,
    divide,
    flax_init_,
    flax_order,
)
from feature_tracker_tpu_torch.models.raft import Raft, RaftConfig, full_float32
from feature_tracker_tpu_torch.train.optim import (
    ClipAdamW,
    _flat,
    _unflat,
    apply_updates,
    warmup_cosine_schedule,
)


@dataclasses.dataclass(frozen=True)
class RaftTrainConfig:
    learning_rate: float = 2e-4
    weight_decay: float = 1e-5
    clip_norm: float = 1.0
    gamma: float = 0.8  # per-iteration loss decay (RAFT paper)
    # Warm-up and cosine decay over this many steps (0 = constant lr).
    schedule_steps: int = 0
    warmup_frac: float = 0.05


@dataclasses.dataclass(frozen=True)
class TrainState:
    """``step`` (int32 0-dim), ``params`` and ``batch_stats`` (dicts of
    tensors keyed as the model's ``state_dict``, in the order JAX flattens
    the Flax tree) and ``opt_state`` (``ClipAdamW``'s)."""

    step: torch.Tensor
    params: dict
    batch_stats: dict
    opt_state: dict

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TrainState":
        """The same state with every tensor on ``device``."""
        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            return tree.to(device)

        return TrainState(step=self.step.to(device),
                          params=move(self.params),
                          batch_stats=move(self.batch_stats),
                          opt_state=move(self.opt_state))

    def leaves(self) -> list:
        """Every tensor of the state, in a fixed order."""
        opt = self.opt_state
        return [self.step, *self.params.values(), *self.batch_stats.values(),
                opt["count"], *opt["mu"].values(), *opt["nu"].values()]


def make_optimizer(cfg: RaftTrainConfig) -> ClipAdamW:
    if cfg.schedule_steps > 0:
        warm = max(1, int(cfg.schedule_steps * cfg.warmup_frac))
        lr = warmup_cosine_schedule(cfg.learning_rate, warm,
                                    cfg.schedule_steps)
    else:
        lr = cfg.learning_rate
    return ClipAdamW(lr, weight_decay=cfg.weight_decay,
                     clip_norm=cfg.clip_norm)


def split_state(state: dict) -> tuple:
    """(params, batch_stats) of a ``Raft`` ``state_dict``, in Flax's
    order, without ``num_batches_tracked``."""
    ordered = flax_order(state)
    stats = {k: v for k, v in ordered.items() if ".running_" in k}
    return {k: v for k, v in ordered.items() if k not in stats}, stats


def create_train_state(rng, raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                       sample_shape, device="cuda"):
    """A fresh state: weights drawn as Flax's initializers draw them from
    ``rng`` (an int seed or a ``torch.Generator``; ``flax_init_``),
    running means 0 and variances 1, zero moments. ``sample_shape`` is
    accepted for the JAX signature (a torch module needs no example
    input). The tensors live on ``device`` (default ``"cuda"``)."""
    del sample_shape
    dev = resolve_device(device)
    model = flax_init_(Raft(raft_cfg, device="cpu"), rng)
    params, stats = split_state(model.state_dict())
    params = {k: v.to(dev).contiguous() for k, v in params.items()}
    stats = {k: v.to(dev).contiguous() for k, v in stats.items()}
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, batch_stats=stats,
                      opt_state=make_optimizer(train_cfg).init(params))


def _global(mesh, sums, count: int):
    """(``sums`` of the whole batch, its element count): with a mesh, this
    rank's sums are summed over its ranks, differentiably."""
    if mesh is None:
        return sums, count
    from feature_tracker_tpu_torch.parallel.mesh import all_reduce_sum
    return all_reduce_sum(mesh, sums), count * mesh.size()


def _decay_weights(t: int, gamma: float, like):
    """``gamma ** [t-1, ..., 0]`` in float32."""
    k = torch.arange(t - 1, -1, -1, dtype=like.dtype, device=like.device)
    return torch.pow(torch.full((), gamma, dtype=like.dtype,
                                device=like.device), k)


def _sequence_loss(predictions, gt_flow, gamma: float, mesh):
    diff = _abs(predictions - gt_flow[None])
    sums, count = _global(mesh, diff.sum((1, 2, 3, 4)), diff[0].numel())
    l1 = divide(sums, float(count))
    return torch.sum(_decay_weights(predictions.shape[0], gamma,
                                    predictions) * l1)


def sequence_loss(predictions, gt_flow, gamma: float):
    """Exponentially weighted L1 over per-iteration predictions.

    Args:
      predictions: ``[T, B, H, W, 2]``; gt_flow: ``[B, H, W, 2]``.
    """
    return _sequence_loss(predictions, gt_flow, gamma, None)


def _warp_bilinear(img, flow):
    """Backward warp: sample ``img`` at p + flow(p).

    img ``[B, H, W, C]``, flow ``[B, H, W, 2]`` (dx, dy). Returns
    (warped ``[B, H, W, C]``, valid ``[B, H, W, 1]`` — 1 where all four
    taps land inside the image)."""
    b, h, w, c = img.shape
    gx, gy = torch.meshgrid(
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        torch.arange(h, dtype=flow.dtype, device=flow.device), indexing="xy")
    x = gx[None] + flow[..., 0]
    y = gy[None] + flow[..., 1]
    valid = ((x >= 0) & (x <= w - 1) & (y >= 0)
             & (y <= h - 1)).to(img.dtype)[..., None]
    x = _clip(x, 0.0, w - 1.001)
    y = _clip(y, 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    out = ((1 - fy) * (1 - fx) * tap(y0i, x0i)
           + (1 - fy) * fx * tap(y0i, x0i + 1)
           + fy * (1 - fx) * tap(y0i + 1, x0i)
           + fy * fx * tap(y0i + 1, x0i + 1))
    return out, valid


def _smoothness_sums(flow, image):
    """(sums of the x and y terms, their element counts) of
    :func:`_edge_aware_smoothness`."""
    di_x = _abs(image[:, :, 1:] - image[:, :, :-1]).mean(-1, keepdim=True)
    di_y = _abs(image[:, 1:] - image[:, :-1]).mean(-1, keepdim=True)
    tx = torch.exp(divide(-di_x, 8.0)) * _abs(flow[:, :, 1:]
                                                 - flow[:, :, :-1])
    ty = torch.exp(divide(-di_y, 8.0)) * _abs(flow[:, 1:] - flow[:, :-1])
    return torch.stack([tx.sum(), ty.sum()]), (tx.numel(), ty.numel())


def _edge_aware_smoothness(flow, image):
    """First-order smoothness of the flow, downweighted at image edges
    (exp(-|dI|/8) on 0..255 gray) — the standard unsupervised-flow
    regularizer that keeps the photometric term from collapsing into
    noise in textureless regions."""
    sums, (nx, ny) = _smoothness_sums(flow, image)
    return divide(sums[0], float(nx)) + divide(sums[1], float(ny))


def _photometric_loss(predictions, ref, cur, gamma: float,
                      smooth_weight: float, mesh):
    t = predictions.shape[0]
    rows = []
    for k in range(t):
        warped, valid = _warp_bilinear(cur, predictions[k])
        resid = divide(ref - warped, 255.0)
        smooth, (nx, ny) = _smoothness_sums(divide(predictions[k], 8.0), ref)
        rows.append(torch.cat([
            torch.stack([torch.sum(valid * torch.sqrt(resid * resid + 1e-6)),
                         torch.sum(valid)]), smooth]))
    sums, _ = _global(mesh, torch.stack(rows), 0)
    world = 1 if mesh is None else mesh.size()
    weights = _decay_weights(t, gamma, predictions)
    total = 0.0
    for k in range(t):
        photo = sums[k, 0] / torch.clamp(sums[k, 1], min=1.0)
        smooth = (divide(sums[k, 2], float(nx * world))
                  + divide(sums[k, 3], float(ny * world)))
        total = total + weights[k] * (photo + smooth_weight * smooth)
    return total


def photometric_sequence_loss(predictions, ref, cur, gamma: float,
                              smooth_weight: float = 0.05):
    """Unsupervised photometric-warp loss over per-iteration predictions:
    a Charbonnier penalty on the 0..1-scaled warp residual over in-image
    pixels, weighted per iteration as in :func:`sequence_loss`, plus an
    edge-aware smoothness term on each predicted flow."""
    return _photometric_loss(predictions, ref, cur, gamma, smooth_weight,
                             None)


def _check_mesh(mesh) -> None:
    if mesh is None:
        return
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if name != "data" and size > 1:
            raise ValueError(
                f"mesh axis {name!r} of size {size}: the port's RAFT "
                "trainers shard the batch over 'data' only; height "
                "sharding over 'model' is ROADMAP.md section 1, item 8c")


def _local_batch(mesh, arrays):
    """This rank's slice of the batch axis of every array."""
    if mesh is None:
        return arrays
    from feature_tracker_tpu_torch.parallel.sharded import shard_features
    n = arrays[0].shape[0]
    if n % mesh.size():
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.size()} ranks")
    return shard_features(mesh, *arrays)[1:]


def _mean_norm(flow, mesh):
    """Mean over pixels of |flow| (the last axis), over the whole batch."""
    norms = torch.linalg.vector_norm(flow, dim=-1)
    total, count = norms.sum(), norms.numel()
    if mesh is not None:
        from feature_tracker_tpu_torch.parallel.mesh import _all_reduce
        total = _all_reduce(mesh, total.clone())
        count *= mesh.size()
    return divide(total, float(count))


def _make_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig, mesh,
               loss_fn, metrics_fn):
    """The step shared by both trainers: ``loss_fn(preds, batch, mesh)``
    is the whole batch's loss, ``metrics_fn(preds, batch, mesh)`` the
    metrics besides it."""
    _check_mesh(mesh)
    tx = make_optimizer(train_cfg)
    models = {}

    def model_on(dev):
        if dev not in models:
            models[dev] = Raft(raft_cfg, device=dev, mesh=mesh)
        return models[dev]

    def train_step(state: TrainState, *batch):
        dev = state.step.device
        batch = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in batch]
        batch = _local_batch(mesh, batch)
        flat = _flat(state.params).requires_grad_()
        params = _unflat(flat, state.params)
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        with full_float32():
            preds, new_stats = functional_call(
                model_on(dev), {**params, **stats}, (batch[0], batch[1]),
                {"train": True})
            loss = loss_fn(preds, batch, mesh)
            # Every rank holds the whole batch's loss; each backpropagates
            # its share, and the all-reduces inside the loss sum them.
            world = 1 if mesh is None else mesh.size()
            (grad,) = torch.autograd.grad(divide(loss, float(world)), flat)
        if mesh is not None:
            from feature_tracker_tpu_torch.parallel.mesh import _all_reduce
            grad = _all_reduce(mesh, grad)
        params = _unflat(flat.detach(), state.params)
        updates, new_opt = tx.update(_unflat(grad, state.params),
                                     state.opt_state, params)
        new_state = TrainState(
            step=state.step + 1, params=apply_updates(params, updates),
            batch_stats={k: new_stats[k] for k in state.batch_stats},
            opt_state=new_opt)
        metrics = {"loss": loss.detach(),
                   **metrics_fn(preds.detach(), batch, mesh)}
        return new_state, metrics

    return train_step


def make_train_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                    mesh=None):
    """The supervised step ``(state, ref, cur, gt_flow) -> (new_state,
    {"loss", "epe"})``; inputs ``[B, H, W, C]`` and ``[B, H, W, 2]``
    (tensors or numpy), moved to the state's device. With a mesh (a
    ``parallel.make_mesh`` over the ranks, each calling the step with the
    whole batch), the batch is split over its ``data`` axis."""

    def loss_fn(preds, batch, mesh_):
        return _sequence_loss(preds, batch[2], train_cfg.gamma, mesh_)

    def metrics_fn(preds, batch, mesh_):
        return {"epe": _mean_norm(preds[-1] - batch[2], mesh_)}

    return _make_step(raft_cfg, train_cfg, mesh, loss_fn, metrics_fn)


def make_unsup_train_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                          smooth_weight: float = 0.05, mesh=None):
    """Photometric-warp (unsupervised) train step ``(state, ref, cur) ->
    (new_state, {"loss", "mean_flow"})`` for real frame pairs with no flow
    ground truth. Same state and optimizer contract as
    :func:`make_train_step`; reports the photometric loss and the mean
    |flow| of the final iteration."""

    def loss_fn(preds, batch, mesh_):
        return _photometric_loss(preds, batch[0], batch[1], train_cfg.gamma,
                                 smooth_weight, mesh_)

    def metrics_fn(preds, batch, mesh_):
        return {"mean_flow": _mean_norm(preds[-1], mesh_)}

    return _make_step(raft_cfg, train_cfg, mesh, loss_fn, metrics_fn)


def data_parallel_case(mesh, raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                       state: TrainState, ref, cur, gt_flow,
                       checkpoint_dir=None) -> dict:
    """One data-parallel supervised step on this rank, the body of a case
    of ``parallel/multihost_ba.py::run_cases``: the state and the whole
    batch go to the mesh's device (this rank's card, or the CPU). Returns
    the new state (its fields as a dict of CPU tensors, which the spawn
    helper returns as numpy), the loss and EPE, and the all-reduce calls
    and bytes of the step (``comm_stats``). With ``checkpoint_dir``, the
    new state is also saved there through the mesh's ``CheckpointManager``
    (rank 0 writes) and restored on every rank: ``saved`` and
    ``restored_equal`` say how that went."""
    from feature_tracker_tpu_torch.parallel.mesh import comm_stats
    from feature_tracker_tpu_torch.train.checkpoint import CheckpointManager

    step = make_train_step(raft_cfg, train_cfg, mesh)
    state = state.to(torch.device(mesh.device_type))
    before = comm_stats().get("all_reduce", {"calls": 0, "bytes": 0})
    new_state, metrics = step(state, ref, cur, gt_flow)
    after = comm_stats()["all_reduce"]
    out = {"state": dataclasses.asdict(new_state.to("cpu")),
           "loss": float(metrics["loss"]), "epe": float(metrics["epe"]),
           "all_reduce_calls": after["calls"] - before["calls"],
           "all_reduce_bytes": after["bytes"] - before["bytes"]}
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir, mesh=mesh)
        out["saved"] = manager.save(int(new_state.step), new_state)
        restored = manager.restore(new_state)
        out["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(restored.leaves(),
                                              new_state.leaves()))
    return out
