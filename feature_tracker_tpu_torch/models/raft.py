"""RAFT optical flow, inference and training — the counterpart of
``feature_tracker_tpu/models/raft.py``.

Same public names, argument order, layouts and return shapes as the Flax
model: tensors are ``[B, H, W, C]`` at every public function and module,
locations and flows are (x, y) pairs. Inside, a convolution sees its
input as the ``[B, C, H, W]`` view of the same memory (channels last), so
no layout copy is made between layers and the correlation lookup reads
the feature maps as they lie.

 - FeatureEncoder: conv7 stem -> 3 ResNet stages with stride 2 at each
   stage end (output H/8 x W/8), channels c/4 -> c/2 -> 3c/4 -> c, conv3
   out; the context encoder is the same trunk split into (context, hidden).
 - Correlation: either the all-pairs volume <fmap0, fmap1>/sqrt(C), 2x2
   average-pooled per level and sampled bilinearly with zero padding
   (``compute_correlation_pyramid`` + ``lookup_correlation``), or
   (``low_memory``) the pooled feature pyramid of the second image and
   windowed correlations computed on the fly
   (``ops/cuda_raft_lookup.py::lookup_correlation_cuda``: a hand-written
   CUDA kernel for CUDA tensors, ``lookup_correlation_otf`` here for CPU
   tensors).
 - UpdateBlock: motion encoder, separable ConvGRU (horizontal then
   vertical 1D kernels of 5), flow head, mask head scaled by 0.25.
 - Convex upsampling: softmax over the 9 neighbours of the 8x-scaled flow.

Submodules carry the Flax model's auto-generated names (``Conv_0``,
``ResNetBlock_3``, ``UpdateBlock_0`` ...), so a checkpoint leaf's path is
its ``state_dict`` key (``convert.py::raft_state_from_jax``).

Precision: with ``dtype=torch.bfloat16`` parameters stay float32 and each
layer computes in bfloat16, as Flax's ``dtype`` does; feature maps return
to float32 before the correlation, the lookup's result is cast to
``dtype``, locations stay float32, and the flow and mask heads' last
convolutions compute in float32. ``Raft.forward`` runs with TF32 switched
off for convolutions and matrix products and restores the caller's
settings afterwards: TF32 keeps about three decimal digits, which the
float32 model's agreement with the reference does not survive.

Training (``forward(ref, cur, train=True)``, Flax's ``train=True`` with
``mutable=["batch_stats"]``): batch normalisation uses the statistics of
the batch, as Flax computes them, and updates the running statistics in
place; the feature encoder runs on each image separately, as in the Flax
model, so each image has its own batch statistics and the running ones
are updated twice; gradients flow through every refinement iteration (no
detach between them). The trainers (``train/raft_train.py``) evaluate it
with ``torch.func.functional_call`` over the tensors of a ``TrainState``;
on a mesh with a ``model`` axis they pass ``bands`` and each rank computes
on its band of image rows (``parallel/height.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import divide, flax_order
from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
    correlation_scale,
    lookup_correlation_cuda,
)
from feature_tracker_tpu_torch.utils.graphs import GraphCache
from feature_tracker_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Defaults are the full configuration."""

    in_channels: int = 1
    hidden_channels: int = 64
    feature_channels: int = 128
    context_channels: int = 128
    correlation_pyramid_levels: int = 3
    correlation_radius: int = 3
    correlation_hidden_channels: int = 64
    correlation_out_channels: int = 32
    flow_hidden_channels: int = 32
    flow_out_channels: int = 16
    motion_out_channels: int = 32
    mask_hidden_channels: int = 64
    max_iterations: int = 5
    # True: never materialize the [B*H*W, H, W] all-pairs volume; compute
    # windowed correlations on the fly (O(HW) memory).
    low_memory: bool = False
    dtype: torch.dtype = torch.float32  # compute dtype (or bfloat16)
    # True: only the final iteration's flow is upsampled and returned (the
    # mask head still runs every iteration); the result has length 1.
    upsample_last_only: bool = False


@contextlib.contextmanager
def full_float32():
    """Switch TF32 off for cuDNN convolutions and CUDA matrix products
    inside the block, and restore the caller's settings after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Conv(nn.Conv2d):
    """Convolution on ``[B, H, W, C]`` with torch-style ``k // 2`` padding.
    Parameters are float32; they and the input are cast to ``dtype`` for
    the product.

    With ``bands`` (``parallel/height.py::RowBands``, height sharding) the
    input is this rank's band of rows: a kernel taller than one row reads
    the ``kh // 2`` rows of the bands around it through ``bands.halo`` and
    pads W only (``haloed``: the input carries those rows already). A band
    starts on an even row, so a stride-2 kernel keeps its phase and the
    strided 1x1 subsample stays local."""

    def __init__(self, in_features, features, kernel, stride=1,
                 dtype=torch.float32):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        super().__init__(in_features, features, (kh, kw), stride,
                         padding=(kh // 2, kw // 2))
        self.compute_dtype = dtype

    def forward(self, x, bands=None, haloed=False):
        dt = self.compute_dtype
        padding = self.padding
        if bands is not None and self.kernel_size[0] > 1:
            if not haloed:
                x = bands.halo(x, self.kernel_size[0] // 2)
            padding = (0, padding[1])
        x, stride = x.permute(0, 3, 1, 2), self.stride
        if self.kernel_size == (1, 1) and stride != (1, 1):
            # The same products as the strided 1x1 convolution; PyTorch's
            # CPU backward of that one on channels-last input crashes.
            x, stride = x[:, :, ::stride[0], ::stride[1]], 1
        y = F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride,
                     padding)
        return y.permute(0, 2, 3, 1)


def _halo(x, bands, k):
    """``x`` with ``k`` halo rows from the bands around it (unchanged
    without ``bands``): one exchange for several convolutions that read
    the same input."""
    return x if bands is None else bands.halo(x, k)


class BatchNorm(nn.BatchNorm2d):
    """Batch normalisation on ``[B, H, W, C]``; Flax's ``momentum=0.9`` is
    ``momentum=0.1`` here.

    ``train=False`` normalises by the running statistics. Where one of them
    requires grad (the SuperPoint trainer optimises them, as the JAX one
    does), the normalisation is written out in Flax's order, since
    ``F.batch_norm`` does not differentiate them.

    ``train=True`` is Flax's training mode: the batch's mean and biased
    variance ``E[x^2] - E[x]^2`` (``use_fast_variance``), summed over the
    ranks of ``mesh`` when one is set (data-parallel training; with
    ``bands``, the input is a band of rows and the count is the whole
    batch's), and the running statistics updated in place to
    ``0.9 * old + 0.1 * batch``.
    ``F.batch_norm``'s training mode would update the running variance
    with the unbiased variance instead."""

    mesh = None

    def __init__(self, features):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x, train: bool = False, bands=None):
        if train:
            return self._batch_statistics(x, bands)
        if self.running_mean.requires_grad or self.running_var.requires_grad:
            return self._normalize(x, self.running_mean, self.running_var)
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias, False,
                         0.0, self.eps)
        return y.permute(0, 2, 3, 1)

    def _normalize(self, x, mean, var):
        """Flax's ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, in
        float32, returned in ``x``'s dtype."""
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)

    def _batch_statistics(self, x, bands):
        xf = x.float()
        count = xf.numel() // xf.shape[-1]
        sums = torch.stack([xf.sum((0, 1, 2)), (xf * xf).sum((0, 1, 2))])
        if self.mesh is not None:
            from feature_tracker_tpu_torch.parallel.height import whole_count
            from feature_tracker_tpu_torch.parallel.mesh import all_reduce_sum
            sums = all_reduce_sum(self.mesh, sums)
            count = whole_count(self.mesh, bands, count, x.shape[1])
        mean, mean2 = divide(sums, float(count))
        var = torch.maximum(torch.zeros_like(mean), mean2 - mean * mean)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean
                                    + (1.0 - 0.9) * mean)
            self.running_var.copy_(0.9 * self.running_var
                                   + (1.0 - 0.9) * var)
        return self._normalize(x, mean, var)


class ResNetBlock(nn.Module):
    def __init__(self, in_features, features, stride=1,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(features)
        self.projects = stride != 1 or in_features != features
        if self.projects:
            self.Conv_2 = Conv(in_features, features, 1, stride, dtype)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x, train: bool = False, bands=None):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x, bands), train, bands))
        h = self.BatchNorm_1(self.Conv_1(h, bands), train, bands)
        if self.projects:
            x = self.BatchNorm_2(self.Conv_2(x, bands), train, bands)
        return F.relu(h + x)


class FeatureEncoder(nn.Module):
    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        super().__init__()
        step = out_channels // 4
        self.Conv_0 = Conv(in_channels, step, 7, 1, dtype)
        widths = (step, step, step * 2, step * 2, step * 3, step * 3,
                  out_channels)
        for i in range(6):
            setattr(self, f"ResNetBlock_{i}",
                    ResNetBlock(widths[i], widths[i + 1], 1 + i % 2, dtype))
        self.Conv_1 = Conv(out_channels, out_channels, 3, 1, dtype)

    def forward(self, x, train: bool = False, bands=None):
        x = F.relu(self.Conv_0(x, bands))
        self.stem_rows = x.shape[1]
        for i in range(6):
            x = getattr(self, f"ResNetBlock_{i}")(x, train, bands)
        return F.relu(self.Conv_1(x, bands))


def _pool2x2(x):
    """2x2 average over dims 1 and 2; an odd last row or column drops."""
    h2 = (x.shape[1] // 2) * 2
    w2 = (x.shape[2] // 2) * 2
    return 0.25 * (x[:, 0:h2:2, 0:w2:2] + x[:, 1:h2:2, 0:w2:2]
                   + x[:, 0:h2:2, 1:w2:2] + x[:, 1:h2:2, 1:w2:2])


def compute_correlation_pyramid(fmap0, fmap1, num_levels: int):
    """All-pairs correlation pyramid.

    Args:
      fmap0, fmap1: ``[B, H, W, C]``.

    Returns:
      list of ``[B*H*W, H_i, W_i]`` volumes (level 0 first). Under height
      sharding ``fmap0`` is this rank's band of rows and ``fmap1`` the
      whole map: each rank holds its band's rows of the volumes.
    """
    b, h, w, c = fmap0.shape
    h1, w1 = fmap1.shape[1:3]
    f0 = fmap0.reshape(b, h * w, c)
    f1 = fmap1.reshape(b, h1 * w1, c)
    corr = torch.einsum("bnc,bmc->bnm", f0, f1) / math.sqrt(c)
    pyramid = [corr.reshape(b * h * w, h1, w1)]
    for _ in range(num_levels - 1):
        pyramid.append(_pool2x2(pyramid[-1]))
    return pyramid


def pool_feature_pyramid(fmap1, num_levels: int):
    """Half-resolution 2x2-average pyramid of the SECOND image's feature
    map. Correlation is linear in f1, so pooling the features first and
    dotting later equals pooling the correlation volume, without ever
    materializing it. Returns list of ``[B, h_i, w_i, C]``."""
    pyr = [fmap1]
    for _ in range(num_levels - 1):
        pyr.append(_pool2x2(pyr[-1]))
    return pyr


def _window_offsets(radius: int, like):
    """``[(2r+1)^2, 2]`` integer (dx, dy) offsets, dy-major, dx-minor."""
    d = torch.arange(-radius, radius + 1, dtype=like.dtype,
                     device=like.device)
    dxx, dyy = torch.meshgrid(d, d, indexing="xy")
    return torch.stack([dxx.reshape(-1), dyy.reshape(-1)], dim=-1)


def _bilinear_taps(pos, h: int, w: int):
    """The four taps of bilinear sampling at ``pos [..., 2]`` (x, y) on an
    ``h x w`` map: ``(yi, xi, weight, ok)`` each ``[...]``. ``ok`` is false
    where the tap leaves the map; it is decided on the floored float, so a
    NaN or infinite position has no valid tap, and its indices read 0."""
    x0 = torch.floor(pos[..., 0])
    y0 = torch.floor(pos[..., 1])
    fx = pos[..., 0] - x0
    fy = pos[..., 1] - y0
    taps = []
    for yf, xf, wgt in ((y0, x0, (1 - fy) * (1 - fx)),
                        (y0, x0 + 1, (1 - fy) * fx),
                        (y0 + 1, x0, fy * (1 - fx)),
                        (y0 + 1, x0 + 1, fy * fx)):
        ok = (yf >= 0) & (yf <= h - 1) & (xf >= 0) & (xf <= w - 1)
        zero = torch.zeros_like(yf)
        taps.append((torch.where(ok, yf, zero).long(),
                     torch.where(ok, xf, zero).long(), wgt, ok))
    return taps


def _clamp_to_map(pos, h: int, w: int):
    """``pos [..., 2]`` (x, y) clamped into ``[0, w - 1] x [0, h - 1]``; a
    position with a NaN or infinite coordinate becomes NaN (no valid tap)."""
    hi = torch.tensor([w - 1, h - 1], dtype=pos.dtype, device=pos.device)
    clamped = torch.minimum(torch.maximum(pos, torch.zeros_like(hi)), hi)
    finite = torch.isfinite(pos).all(-1, keepdim=True)
    return torch.where(finite, clamped, torch.full_like(pos, float("nan")))


def lookup_correlation_otf(fmap0, fmap1_pyramid, locations, radius: int,
                           padding: str = "zeros"):
    """Memory-light correlation lookup: the windowed correlations computed
    on the fly instead of sampled from a precomputed all-pairs volume.
    Numerically equal to compute_correlation_pyramid + lookup_correlation,
    because pooling commutes with the dot product and both use zero-padded
    bilinear taps. This is the plain version of the CUDA kernel behind
    ``lookup_correlation_cuda``.

    ``padding="border"`` (CoTracker's ``grid_sample(padding_mode="border",
    align_corners=True)``) clamps every sample position into
    ``[0, w_l - 1] x [0, h_l - 1]`` before its four taps, so that no tap
    with weight leaves the map; a NaN or infinite location still gives
    zeros.

    Args:
      fmap0: ``[B, H, W, C]``; fmap1_pyramid: list of ``[B, h, w, C]``;
      locations: ``[B, H, W, 2]`` (x, y) at level-0 scale.

    Returns:
      ``[B, H, W, L*(2r+1)^2]``, level-major, then dy-major, dx-minor.
    """
    if padding not in ("zeros", "border"):
        raise ValueError(f"padding must be 'zeros' or 'border', got "
                         f"{padding!r}")
    b, h, w, c = fmap0.shape
    k = 2 * radius + 1
    f0 = fmap0.reshape(b, h * w, c) * correlation_scale(c)
    offsets = _window_offsets(radius, locations)
    centers = locations.reshape(b, h * w, 2)
    batch = torch.arange(b, device=fmap0.device)[:, None]
    out = []
    for lvl, f1 in enumerate(fmap1_pyramid):
        base = centers / (2.0 ** lvl)
        corr = []
        for off in offsets:
            total = 0.0
            pos = base + off
            if padding == "border":
                pos = _clamp_to_map(pos, f1.shape[1], f1.shape[2])
            for yi, xi, wgt, ok in _bilinear_taps(pos, f1.shape[1],
                                                  f1.shape[2]):
                rows = f1[batch, yi, xi]                      # [B, HW, C]
                dot = (f0 * rows).sum(-1)
                total = total + torch.where(ok, wgt * dot,
                                            torch.zeros_like(dot))
            corr.append(total)                                # [B, HW]
        out.append(torch.stack(corr, dim=-1).reshape(b, h, w, k * k))
    return torch.cat(out, dim=-1)


def _bilinear_zeros(vol, pos):
    """Bilinear sample with zero padding (each out-of-range tap
    contributes 0).

    Args:
      vol: ``[M, h, w]``.
      pos: ``[M, K, 2]`` (x, y) pixel coordinates.

    Returns:
      ``[M, K]``.
    """
    m = torch.arange(vol.shape[0], device=vol.device)[:, None]
    total = 0.0
    for yi, xi, wgt, ok in _bilinear_taps(pos, vol.shape[1], vol.shape[2]):
        v = vol[m, yi, xi]
        total = total + torch.where(ok, v * wgt, torch.zeros_like(v))
    return total


def lookup_correlation(pyramid: Sequence, locations, radius: int):
    """Sample (2r+1)^2 windows around ``locations/2^level`` per level.

    Args:
      pyramid: list of ``[B*H*W, h_i, w_i]``.
      locations: ``[B, H, W, 2]`` current pixel locations (x, y).

    Returns:
      ``[B, H, W, L*(2r+1)^2]`` correlation features.
    """
    b, h, w, _ = locations.shape
    k = 2 * radius + 1
    offsets = _window_offsets(radius, locations)
    centers = locations.reshape(b * h * w, 1, 2)
    out = []
    for i, vol in enumerate(pyramid):
        pos = centers / (2.0 ** i) + offsets[None, :, :]
        out.append(_bilinear_zeros(vol, pos).reshape(b, h, w, k * k))
    return torch.cat(out, dim=-1)


class SepConvGru(nn.Module):
    def __init__(self, in_features, hidden, kernel=5, dtype=torch.float32):
        super().__init__()
        for direction, shape in (("h", (1, kernel)), ("v", (kernel, 1))):
            for gate in "zrq":
                setattr(self, f"conv_{gate}_{direction}",
                        Conv(in_features + hidden, hidden, shape, 1, dtype))

    def forward(self, x, h, bands=None):
        for d in "hv":
            # The (1, k) convolutions need no halo; z and r of the (k, 1)
            # ones read the same rows.
            xh = torch.cat([x, h], dim=-1)
            if d == "v":
                xh = _halo(xh, bands, self.conv_z_v.kernel_size[0] // 2)
            z = torch.sigmoid(getattr(self, f"conv_z_{d}")(xh, bands, True))
            r = torch.sigmoid(getattr(self, f"conv_r_{d}")(xh, bands, True))
            q = torch.tanh(getattr(self, f"conv_q_{d}")(
                torch.cat([x, r * h], dim=-1), bands))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    def __init__(self, cfg: RaftConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        k = 2 * c.correlation_radius + 1
        self.Conv_0 = Conv(c.correlation_pyramid_levels * k * k,
                           c.correlation_hidden_channels, 1, 1, dt)
        self.Conv_1 = Conv(c.correlation_hidden_channels,
                           c.correlation_out_channels, 3, 1, dt)
        self.Conv_2 = Conv(2, c.flow_hidden_channels, 7, 1, dt)
        self.Conv_3 = Conv(c.flow_hidden_channels, c.flow_out_channels, 3, 1,
                           dt)
        self.Conv_4 = Conv(c.correlation_out_channels + c.flow_out_channels,
                           c.motion_out_channels - 2, 3, 1, dt)

    def forward(self, corr, flow, bands=None):
        t_corr = F.relu(self.Conv_1(F.relu(self.Conv_0(corr)), bands))
        t_flow = F.relu(self.Conv_3(F.relu(self.Conv_2(flow, bands)), bands))
        out = F.relu(self.Conv_4(torch.cat([t_corr, t_flow], dim=-1), bands))
        return torch.cat([out, flow.to(out.dtype)], dim=-1)


class UpdateBlock(nn.Module):
    """``(net, inp, corr, flow) -> (net, 0.25 * mask, delta)``; ``mask``
    and ``delta`` are float32 whatever ``cfg.dtype`` is, and ``corr`` and
    ``flow`` may come in float32 (the block casts them to ``cfg.dtype``).

    Where ``GraphCache.engages`` (on the card, autograd off, outside a
    stream capture) and without ``bands``, a call replays a CUDA graph of
    the block (``utils/graphs.py``), captured at the first call of its
    signature (``GraphCache.signature``). It launches the kernels the eager
    block launches, on the same values, as one graph instead of ~70
    launches from the host, and returns copies of the graph's outputs (the
    graph's own tensors inside :meth:`_lending`). Every other call
    (training, ``bands``, the CPU) runs the block eagerly. The tracer
    counts ``raft.update_graph.captures`` and
    ``raft.update_graph.replays``."""

    def __init__(self, cfg: RaftConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.MotionEncoder_0 = MotionEncoder(c)
        self.SepConvGru_0 = SepConvGru(
            c.context_channels + c.motion_out_channels, c.hidden_channels, 5,
            dt)
        self.flow_conv1 = Conv(c.hidden_channels, c.flow_out_channels, 3, 1,
                               dt)
        self.flow_conv2 = Conv(c.flow_out_channels, 2, 3, 1, torch.float32)
        self.mask_hidden = Conv(c.hidden_channels, c.mask_hidden_channels, 3,
                                1, dt)
        self.mask_out = Conv(c.mask_hidden_channels, 8 * 8 * 9, 1, 1,
                             torch.float32)
        self.compute_dtype = dt
        self._graphs = GraphCache("raft.update_graph", self)
        self._lends = False

    def forward(self, net, inp, corr, flow, bands=None):
        inputs = (net, inp, corr, flow)
        if bands is None and GraphCache.engages(inputs):
            dt = self.compute_dtype
            out = self._graphs(self._carried, inputs, (None, None, dt, dt),
                               self._lends)
            return out if self._lends else tuple(t.clone() for t in out)
        return self._body(net, inp, corr, flow, bands)

    def _carried(self, net, inp, corr, flow):
        """The block as captured: the new ``net`` is written over the
        graph's own ``net`` input and returned as it, so that a loop that
        passes it back makes no copy."""
        new, mask, delta = self._body(net, inp, corr, flow)
        return net.copy_(new), mask, delta

    @contextlib.contextmanager
    def _lending(self):
        """Inside, a replayed call returns the graph's own output tensors
        instead of copies, which the next replay of the same signature
        overwrites, and takes an input passed again as the same tensor as
        unchanged: for a caller that is done with each output before its
        next call and changes nothing it passes again (``Raft._flows``:
        ``net`` goes back in, ``delta`` and the mask are read at once,
        ``inp`` is the same all through a call)."""
        self._lends = True
        try:
            yield
        finally:
            self._lends = False

    def _body(self, net, inp, corr, flow, bands=None):
        motion = self.MotionEncoder_0(corr, flow, bands)
        net = self.SepConvGru_0(torch.cat([inp, motion], dim=-1), net, bands)
        rows = _halo(net, bands, 1)             # both 3x3 heads read net
        delta = self.flow_conv2(F.relu(self.flow_conv1(rows, bands, True)),
                                bands)
        mask = self.mask_out(F.relu(self.mask_hidden(rows, bands, True)))
        return net, 0.25 * mask, delta


def upsample_flow_convex(flow, mask, bands=None):
    """Learned convex 8x upsampling.

    Args:
      flow: ``[B, H, W, 2]``; mask: ``[B, H, W, 576]``, the channels being
      (neighbour, u, v) = (9, 8, 8). With ``bands``, this rank's band of
      rows: the rows around it come from the neighbouring bands.

    Returns:
      ``[B, 8H, 8W, 2]``.
    """
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    # 3x3 neighbourhoods of 8*flow with zero padding, i-major, j-minor.
    if bands is None:
        fpad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    else:
        fpad = F.pad(bands.halo(8.0 * flow, 1), (0, 0, 1, 1))
    up = 0.0
    for n, (i, j) in enumerate((i, j) for i in range(3) for j in range(3)):
        neigh = fpad[:, i:i + h, j:j + w, None, None, :]    # [B,H,W,1,1,2]
        up = up + neigh * mask[:, :, :, n, :, :, None]      # [B,H,W,8,8,2]
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


def _normalised_frames(img, device, dtype):
    """``img`` (0..255; a numpy array, a tensor or a nested list) on
    ``device`` in -1..1 as ``dtype``.

    Frames are copied in their own dtype (``uint8``: a quarter of
    float32's bytes) and made float32 on ``device``, not on the host (a
    blocking copy that changes the dtype converts there). Either device
    rounds that conversion to nearest, so the values, and the arithmetic
    after them, are the same bits as a host cast's. Counts the bytes
    copied from the host in ``raft.input.h2d_bytes``."""
    src = torch.as_tensor(img)      # numpy arrays and tensors: no copy
    x = src.to(device).to(torch.float32)
    crossed = src.device.type == "cpu" and device.type != "cpu"
    count("raft.input.h2d_bytes", src.nbytes if crossed else 0)
    return (2.0 * (x / 255.0) - 1.0).to(dtype)


class Raft(nn.Module):
    """Full RAFT. ``forward(ref_image, cur_image, train=False)`` takes
    images ``[B, H, W, C]`` with 0..255 gray values (tensors or numpy
    arrays) and returns the per-iteration upsampled flows
    ``[T, B, 8H', 8W', 2]`` with channels (dx, dy); ``T`` is 1 with
    ``cfg.upsample_last_only``. With ``train=True`` it runs with autograd
    and batch statistics and returns ``(flows, new_batch_stats)``, the
    running statistics (``state_dict`` keys, Flax's order) after the call.

    The model runs on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"``) in ``eval()`` mode. With ``cfg.low_memory`` the
    per-iteration lookup goes through ``lookup_fn``, which is
    ``lookup_correlation_cuda``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. The kernel has no backward, so training
    with ``cfg.low_memory`` takes the differentiable plain version
    (``lookup_correlation_otf``) on either device, as JAX does off a TPU.
    With a ``mesh`` (a trainer's), training-mode batch statistics are
    summed over its ranks. In inference on the card each iteration's
    ``UpdateBlock_0`` call replays a CUDA graph of the block, one per
    shape; the lookup stays outside it, one launch of kernel 5 an
    iteration.

    ``bands`` (``parallel/height.py::RowBands``, a trainer's on a mesh with
    a ``model`` axis) makes the images this rank's band of rows: every
    layer computes on the band, the second image's feature map is gathered
    whole for the correlation (this rank's rows of the volume, or of the
    on-the-fly lookup, against every row), and the flows returned are the
    band's rows. ``band_rows`` then records the band's first row and rows
    (``"start"``, ``"rows"``) and the row counts of the first encoder
    activation (``"stem"``) and of ``fmap0``."""

    def __init__(self, cfg: RaftConfig = RaftConfig(), device="cuda",
                 mesh=None):
        super().__init__()
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{cfg.dtype}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lookup_fn = lookup_correlation_cuda
        self.feature_enc = FeatureEncoder(cfg.in_channels,
                                          cfg.feature_channels, cfg.dtype)
        self.context_enc = FeatureEncoder(
            cfg.in_channels, cfg.context_channels + cfg.hidden_channels,
            cfg.dtype)
        self.UpdateBlock_0 = UpdateBlock(cfg)
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.mesh = mesh
        self.to(self.device).to(memory_format=torch.channels_last)
        self.eval()

    def forward(self, ref_image, cur_image, train: bool = False,
                bands=None):
        if not train:
            with torch.inference_mode(), full_float32():
                return self._forward(ref_image, cur_image, False, bands)
        with full_float32():
            flows = self._forward(ref_image, cur_image, True, bands)
        stats = {k: v for k, v in self.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return flows, flax_order(stats)

    def _forward(self, ref_image, cur_image, train, bands):
        with span("raft.forward"):
            return self._flows(ref_image, cur_image, train, bands)

    def _flows(self, ref_image, cur_image, train, bands):
        c = self.cfg
        with span("raft.input"):
            ref, cur = (_normalised_frames(img, self.device, c.dtype)
                        for img in (ref_image, cur_image))
        b = ref.shape[0]

        if train:
            # One call per image, as in the Flax model: each has its own
            # batch statistics, and the second reads the running statistics
            # as the first left them.
            fmap0 = self.feature_enc(ref, True, bands).float()
            fmap1 = self.feature_enc(cur, True, bands).float()
        else:
            # Both images in one pass: the statistics are the running ones,
            # so the batch does not couple its items.
            fmaps = self.feature_enc(torch.cat([ref, cur]), False,
                                     bands).float()
            fmaps = fmaps.contiguous()
            fmap0, fmap1 = fmaps[:b], fmaps[b:]
        if bands is not None:
            self.band_rows = {"start": bands.start, "rows": ref.shape[1],
                              "stem": self.feature_enc.stem_rows,
                              "fmap0": fmap0.shape[1]}
            fmap1 = bands.gather(fmap1)
        ctx = self.context_enc(ref, train, bands)
        inp = ctx[..., :c.context_channels]
        net = ctx[..., c.context_channels:]

        if c.low_memory:
            fpyr = [f.contiguous() for f in pool_feature_pyramid(
                fmap1, c.correlation_pyramid_levels)]
            lookup = lookup_correlation_otf if train else self.lookup_fn
        else:
            pyramid = compute_correlation_pyramid(
                fmap0, fmap1, c.correlation_pyramid_levels)

        _, h, w, _ = fmap0.shape
        y0 = 0 if bands is None else bands.offset(h)    # rows are global
        xs = torch.arange(w, dtype=torch.float32, device=self.device)
        ys = torch.arange(y0, y0 + h, dtype=torch.float32, device=self.device)
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        ref_locs = torch.stack([gx, gy], dim=-1)[None].expand(
            b, h, w, 2).contiguous()

        cur_locs = ref_locs
        predictions = []
        with self.UpdateBlock_0._lending():
            for _ in range(c.max_iterations):
                if c.low_memory:
                    corr = lookup(fmap0, fpyr, cur_locs,
                                  c.correlation_radius)
                else:
                    corr = lookup_correlation(pyramid, cur_locs,
                                              c.correlation_radius)
                with span("raft.update"):
                    net, up_mask, delta = self.UpdateBlock_0(
                        net, inp, corr, cur_locs - ref_locs, bands)
                cur_locs = cur_locs + delta.float()
                if not c.upsample_last_only:
                    predictions.append(upsample_flow_convex(
                        cur_locs - ref_locs, up_mask, bands))
        if c.upsample_last_only:
            return upsample_flow_convex(cur_locs - ref_locs, up_mask,
                                        bands)[None]
        return torch.stack(predictions)
