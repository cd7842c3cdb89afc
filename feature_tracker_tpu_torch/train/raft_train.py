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

On a mesh (``parallel.make_mesh``, axes ``data`` and ``model``), the
JAX trainers' ``P("data", "model")``: every rank is given the whole batch
and keeps the slice of the batch axis of its ``data`` coordinate and, with
a ``model`` axis, the band of image rows of its ``model`` coordinate
(``parallel/height.py::RowBands``). The model computes on the band, with
the convolutions' halo rows and the correlation's second feature map
fetched from the other bands; batch normalisation sums its statistics over
the mesh, the loss and the metrics are those of the whole batch, and the
gradient is all-reduced once per step. The result is the one-rank step's
on the whole batch, as under JAX's ``jit``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

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
from feature_tracker_tpu_torch.parallel.height import (
    RowBands,
    model_size,
    whole_count,
)
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


def _global(mesh, bands, sums, count: int, rows: int):
    """(``sums`` of the whole batch, its element count): with a mesh, this
    rank's sums, over ``count`` elements in ``rows`` image rows, are summed
    over its ranks, differentiably."""
    if mesh is None:
        return sums, count
    from feature_tracker_tpu_torch.parallel.mesh import all_reduce_sum
    return all_reduce_sum(mesh, sums), whole_count(mesh, bands, count, rows)


def _decay_weights(t: int, gamma: float, like):
    """``gamma ** [t-1, ..., 0]`` in float32."""
    k = torch.arange(t - 1, -1, -1, dtype=like.dtype, device=like.device)
    return torch.pow(torch.full((), gamma, dtype=like.dtype,
                                device=like.device), k)


def _sequence_loss(predictions, gt_flow, gamma: float, mesh, bands=None):
    diff = _abs(predictions - gt_flow[None])
    sums, count = _global(mesh, bands, diff.sum((1, 2, 3, 4)),
                          diff[0].numel(), diff.shape[2])
    l1 = divide(sums, float(count))
    return torch.sum(_decay_weights(predictions.shape[0], gamma,
                                    predictions) * l1)


def sequence_loss(predictions, gt_flow, gamma: float):
    """Exponentially weighted L1 over per-iteration predictions.

    Args:
      predictions: ``[T, B, H, W, 2]``; gt_flow: ``[B, H, W, 2]``.
    """
    return _sequence_loss(predictions, gt_flow, gamma, None)


def _warp_bilinear(img, flow, y0: int = 0):
    """Backward warp: sample ``img`` at p + flow(p).

    img ``[B, H, W, C]``, flow ``[B, h, W, 2]`` (dx, dy) at the image's rows
    ``y0`` to ``y0 + h - 1`` (all of them by default). Returns (warped
    ``[B, h, W, C]``, valid ``[B, h, W, 1]`` — 1 where all four taps land
    inside the image)."""
    b, h, w, c = img.shape
    hf = flow.shape[1]
    gx, gy = torch.meshgrid(
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        torch.arange(y0, y0 + hf, dtype=flow.dtype, device=flow.device),
        indexing="xy")
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
        idx = (yi * w + xi).reshape(b, hf * w, 1).expand(b, hf * w, c)
        return torch.gather(flat, 1, idx).reshape(b, hf, w, c)

    out = ((1 - fy) * (1 - fx) * tap(y0i, x0i)
           + (1 - fy) * fx * tap(y0i, x0i + 1)
           + fy * (1 - fx) * tap(y0i + 1, x0i)
           + fy * fx * tap(y0i + 1, x0i + 1))
    return out, valid


def _smoothness_sums(flow, image, flow_y=None, image_y=None):
    """(sums of the x and y terms, their element counts) of
    :func:`_edge_aware_smoothness`; the y terms are those of ``flow_y`` and
    ``image_y`` where given (a band of rows with the row below it)."""
    flow_y = flow if flow_y is None else flow_y
    image_y = image if image_y is None else image_y
    di_x = _abs(image[:, :, 1:] - image[:, :, :-1]).mean(-1, keepdim=True)
    di_y = _abs(image_y[:, 1:] - image_y[:, :-1]).mean(-1, keepdim=True)
    tx = torch.exp(divide(-di_x, 8.0)) * _abs(flow[:, :, 1:]
                                                 - flow[:, :, :-1])
    ty = torch.exp(divide(-di_y, 8.0)) * _abs(flow_y[:, 1:] - flow_y[:, :-1])
    return torch.stack([tx.sum(), ty.sum()]), (tx.numel(), ty.numel())


def _edge_aware_smoothness(flow, image):
    """First-order smoothness of the flow, downweighted at image edges
    (exp(-|dI|/8) on 0..255 gray) — the standard unsupervised-flow
    regularizer that keeps the photometric term from collapsing into
    noise in textureless regions."""
    sums, (nx, ny) = _smoothness_sums(flow, image)
    return divide(sums[0], float(nx)) + divide(sums[1], float(ny))


def _photometric_loss(predictions, ref, cur, gamma: float,
                      smooth_weight: float, mesh, bands=None):
    """With ``bands``, ``predictions`` are this rank's band of rows and
    ``ref`` and ``cur`` the whole images: the warp reads ``cur`` at any row,
    and the smoothness's y terms cross into the band below (one halo
    row)."""
    t = predictions.shape[0]
    ref_rows = ref if bands is None else bands.band(ref)
    y0 = 0 if bands is None else bands.start
    rows = []
    for k in range(t):
        warped, valid = _warp_bilinear(cur, predictions[k], y0)
        resid = divide(ref_rows - warped, 255.0)
        flow = divide(predictions[k], 8.0)
        if bands is None:
            smooth, (nx, ny) = _smoothness_sums(flow, ref)
        else:
            h = flow.shape[1]
            below = h + (bands.start + h < bands.height)
            flow_y = bands.halo(flow, 1)[:, 1:1 + below]
            smooth, _ = _smoothness_sums(flow, ref_rows, flow_y,
                                         ref[:, y0:y0 + below])
        rows.append(torch.cat([
            torch.stack([torch.sum(valid * torch.sqrt(resid * resid + 1e-6)),
                         torch.sum(valid)]), smooth]))
    sums, _ = _global(mesh, bands, torch.stack(rows), 0, 1)
    if bands is None:
        world = 1 if mesh is None else mesh.size()
        nx, ny = nx * world, ny * world
    else:                       # the whole batch's [B, H, W, 2] flows
        b, _, w, c = predictions.shape[1:]
        n, hh = b * bands.data, bands.height
        nx, ny = n * hh * (w - 1) * c, n * (hh - 1) * w * c
    weights = _decay_weights(t, gamma, predictions)
    total = 0.0
    for k in range(t):
        photo = sums[k, 0] / torch.clamp(sums[k, 1], min=1.0)
        smooth = (divide(sums[k, 2], float(nx))
                  + divide(sums[k, 3], float(ny)))
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
        if name not in ("data", "model") and size > 1:
            raise ValueError(
                f"mesh axis {name!r} of size {size}: the RAFT trainers "
                "shard the batch over 'data' and the image height over "
                "'model'")


def _local_batch(mesh, arrays):
    """This rank's slice of the batch axis of every array: the slice of its
    ``data`` coordinate, whole in height."""
    if mesh is None:
        return arrays
    n, parts = arrays[0].shape[0], mesh.size() // model_size(mesh)
    if n % parts:
        raise ValueError(f"a batch of {n} does not split over {parts} "
                         "ranks of the 'data' axis")
    i = mesh.get_local_rank("data") if "data" in mesh.mesh_dim_names else 0
    m = n // parts
    return [a[i * m:(i + 1) * m] for a in arrays]


def _mean_norm(flow, mesh, bands=None):
    """Mean over pixels of |flow| (the last axis), over the whole batch."""
    norms = torch.linalg.vector_norm(flow, dim=-1)
    total, count = norms.sum(), norms.numel()
    if mesh is not None:
        from feature_tracker_tpu_torch.parallel.mesh import _all_reduce
        total = _all_reduce(mesh, total.clone())
        count = whole_count(mesh, bands, count, norms.shape[1])
    return divide(total, float(count))


def _make_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig, mesh,
               loss_fn, metrics_fn):
    """The step shared by both trainers: ``loss_fn(preds, batch, mesh,
    bands)`` is the whole batch's loss, ``metrics_fn(preds, batch, mesh,
    bands)`` the metrics besides it; ``batch`` is this rank's slice of the
    batch axis, whole in height, ``preds`` the band's rows with ``bands``.
    The step's ``models`` attribute holds the model of each device it ran
    on."""
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
        bands = (None if mesh is None or model_size(mesh) == 1
                 else RowBands(mesh, batch[0].shape[1]))
        batch = _local_batch(mesh, batch)
        images = [a if bands is None else bands.band(a) for a in batch[:2]]
        flat = _flat(state.params).requires_grad_()
        params = _unflat(flat, state.params)
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        with full_float32():
            preds, new_stats = functional_call(
                model_on(dev), {**params, **stats}, tuple(images),
                {"train": True, "bands": bands})
            loss = loss_fn(preds, batch, mesh, bands)
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
                   **metrics_fn(preds.detach(), batch, mesh, bands)}
        return new_state, metrics

    train_step.models = models
    return train_step


def make_train_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                    mesh=None):
    """The supervised step ``(state, ref, cur, gt_flow) -> (new_state,
    {"loss", "epe"})``; inputs ``[B, H, W, C]`` and ``[B, H, W, 2]``
    (tensors or numpy), moved to the state's device. With a mesh (a
    ``parallel.make_mesh`` over the ranks, each calling the step with the
    whole batch), the batch is split over its ``data`` axis and the image
    height over its ``model`` axis (H a multiple of 8, at least 8 rows a
    band)."""

    def _gt(batch, bands):
        return batch[2] if bands is None else bands.band(batch[2])

    def loss_fn(preds, batch, mesh_, bands):
        return _sequence_loss(preds, _gt(batch, bands), train_cfg.gamma,
                              mesh_, bands)

    def metrics_fn(preds, batch, mesh_, bands):
        return {"epe": _mean_norm(preds[-1] - _gt(batch, bands), mesh_,
                                  bands)}

    return _make_step(raft_cfg, train_cfg, mesh, loss_fn, metrics_fn)


def make_unsup_train_step(raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                          smooth_weight: float = 0.05, mesh=None):
    """Photometric-warp (unsupervised) train step ``(state, ref, cur) ->
    (new_state, {"loss", "mean_flow"})`` for real frame pairs with no flow
    ground truth. Same state and optimizer contract as
    :func:`make_train_step`; reports the photometric loss and the mean
    |flow| of the final iteration."""

    def loss_fn(preds, batch, mesh_, bands):
        return _photometric_loss(preds, batch[0], batch[1], train_cfg.gamma,
                                 smooth_weight, mesh_, bands)

    def metrics_fn(preds, batch, mesh_, bands):
        return {"mean_flow": _mean_norm(preds[-1], mesh_, bands)}

    return _make_step(raft_cfg, train_cfg, mesh, loss_fn, metrics_fn)


def data_parallel_case(mesh, raft_cfg: RaftConfig, train_cfg: RaftTrainConfig,
                       state: TrainState, ref, cur, gt_flow=None,
                       checkpoint_dir=None, shape=None,
                       time_steps: int = 0) -> dict:
    """One supervised step (without ``gt_flow``, the photometric one) on
    this rank of a mesh, the body of a case of
    ``parallel/multihost_ba.py::run_cases``: the state and the whole batch
    go to the mesh's device (this rank's card, or the CPU). ``shape``
    (``{axis: size}``, such as ``{"data": 1, "model": 2}``) makes the
    case's own mesh over the same ranks first; every rank runs the case,
    so the mesh is made by all of them.

    Returns the new state (its fields as a dict of CPU tensors, which the
    spawn helper returns as numpy), the step's metrics (``loss`` and
    ``epe`` or ``mean_flow``), the calls and bytes of each collective of
    the step by operation (``comm``, from ``comm_stats``), with a ``model``
    axis the model's ``band_rows`` (this rank's first row and rows, and the
    rows of its first encoder activation and of ``fmap0``), and on a card
    the step's peak memory (``peak_bytes``). With ``time_steps``, that many
    more steps from the new state follow, each timed on the host clock
    with the device synchronised: ``step_ms`` is their median, the first
    left out. With ``checkpoint_dir``, the
    new state is also saved there through the mesh's ``CheckpointManager``
    (rank 0 writes) and restored on every rank: ``saved`` and
    ``restored_equal`` say how that went."""
    from feature_tracker_tpu_torch.parallel.mesh import comm_stats, make_mesh
    from feature_tracker_tpu_torch.train.checkpoint import CheckpointManager

    if shape is not None:
        mesh = make_mesh(shape, device=mesh.device_type)
    if gt_flow is None:
        step = make_unsup_train_step(raft_cfg, train_cfg, mesh=mesh)
        batch = (ref, cur)
    else:
        step = make_train_step(raft_cfg, train_cfg, mesh)
        batch = (ref, cur, gt_flow)
    dev = torch.device(mesh.device_type)
    state = state.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = comm_stats()
    new_state, metrics = step(state, *batch)
    after = comm_stats()
    out = {"state": dataclasses.asdict(new_state.to("cpu")),
           **{k: float(v) for k, v in metrics.items()},
           "comm": {op: {k: n - before.get(op, {}).get(k, 0)
                         for k, n in rec.items()}
                    for op, rec in after.items()
                    if rec != before.get(op)}}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if model_size(mesh) > 1:
        (model,) = step.models.values()
        out["band_rows"] = dict(model.band_rows)
    if time_steps:
        times, later = [], new_state
        for _ in range(time_steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            later, _ = step(later, *batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["step_ms"] = 1e3 * statistics.median(times[1:])
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir, mesh=mesh)
        out["saved"] = manager.save(int(new_state.step), new_state)
        restored = manager.restore(new_state)
        out["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(restored.leaves(),
                                              new_state.leaves()))
    return out
