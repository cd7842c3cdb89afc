"""CoTracker2 (Karaev et al., CoTracker: It is Better to Track Together,
ECCV 2024, arXiv:2307.07635): the ``CoTracker2`` model of co-tracker's v2.0
release at its published widths, in inference, offline and online.

Tensors are ``[..., C]`` at every public function, as in the rest of the
port; points and tracks are (x, y) in pixels of the model's input.

 - ``fnet`` (``BasicEncoder``): 7x7 stride-2 convolution to 64, instance
   normalisation, ReLU; four stages of two residual blocks (64 stride 1, 96,
   128, 128 stride 2) with instance normalisation after every convolution;
   each stage resized bilinearly (``align_corners=True``) to ``H/4 x W/4``
   and concatenated (416 channels); 3x3 to 256, instance normalisation,
   ReLU, 1x1 to 128. Frames enter as ``2 * (x / 255) - 1``.
 - Correlation: the window's feature maps pooled into ``corr_levels``
   levels (``raft.pool_feature_pyramid``); for track n at frame s, the dot
   product of ``track_feat[s, n] / sqrt(C)`` with each level sampled
   bilinearly at ``coords[s, n] / 2^l`` plus the ``(2r+1)^2`` integer
   offsets, every sample position clamped into the map (``grid_sample``'s
   ``padding_mode="border"``): kernel 5 (``lookup_correlation_cuda`` in
   border mode) on the card, its plain twin here. The tracks are laid out
   as a ``rows x cols`` grid (:func:`track_layout`), each frame a batch
   item, so that the kernel's tiles of 8x8 neighbouring queries are full.
   The release orders each level's ``7 x 7`` samples x-major
   (``meshgrid(dy, dx)`` added to (x, y)); the kernel's dy-major output is
   transposed to that order.
 - Token of a (track, frame): the flow embedding of ``coords[s] -
   coords[0]`` (the raw flow, then sin and cos of x and of y at 32
   frequencies ``k * 1000 / 64``), the correlation, ``track_feat``, the
   track mask and the visibility logit: 456 channels; plus a 2D sin-cos
   embedding of the feature grid sampled at the track's position in the
   window's first frame, and a 1D sin-cos embedding of the frame.
 - ``updateformer`` (``EfficientUpdateFormer``): ``input_transform`` to
   the hidden size, 64 learned virtual tracks appended, then for each of 6
   layers a time ``AttnBlock`` over the frames of every track and, per
   frame, virtual tracks attending to the points (under the attention
   mask), an ``AttnBlock`` over the virtual tracks, and the points
   attending to the virtual tracks; ``flow_head`` of the points: 2
   coordinate and 128 feature deltas. Blocks are pre-norm (LayerNorm
   without affine parameters, eps 1e-6), attention with qkv biases, an MLP
   4x wide with the tanh GELU; a cross block also normalises its context
   (affine LayerNorm, eps 1e-5). Head size ``hidden_size / num_heads`` (48).
 - Per iteration: ``coords += delta[:2]``, ``track_feat +=
   GELU(Linear(GroupNorm(1, 128)(delta[2:])))`` (the exact GELU); after the
   last, the visibility logit ``Linear(128 -> 1)(track_feat)``.
 - Windows of ``window_len`` frames advance by half of it. A window's
   coordinates and visibility start from the window before on the frames
   they share (the new ones from the last known position), the track
   features from those sampled at the query points on their query frames
   (as the release: a window's updated features are not carried).

Entry points: :meth:`CoTracker2.forward` (a whole video, offline) and
:class:`CoTracker2Online` (``step``: the release's online predictor, a call
hands in ``window_len / 2`` new frames and runs the window of the last
``window_len``). Submodules carry the release's names, so that its
checkpoint's parameters load with ``load_state_dict`` (its fixed sin-cos
tables are computed here, not loaded).

Precision: parameters are float32; with ``dtype=torch.bfloat16`` the
convolutions, linear layers and attention compute in bfloat16 (and the
residual stream is held in it); normalisations accumulate in float32, the
attention's softmax statistics are float32 (inside the fused kernel, or
written out over the time blocks' 8 frames), and coordinates, the track
features, the correlation and the embeddings stay float32. Calls run under
``torch.inference_mode`` with TF32 off. On the card each iteration's former
replays a CUDA graph (``EfficientUpdateFormer``); kernel 5 and the rest of
an iteration stay outside it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import Dense
from feature_tracker_tpu_torch.models.raft import (
    Conv,
    full_float32,
    pool_feature_pyramid,
)
from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
    lookup_correlation_cuda,
)
from feature_tracker_tpu_torch.utils.graphs import GraphCache
from feature_tracker_tpu_torch.utils.profiling import count, span

FLOW_FREQUENCIES = 32       # per axis in the flow embedding
VIS_INIT = 10.0             # a new track's visibility logit
SHORT_KEYS = 16             # attention over at most this many keys: unfused


@dataclasses.dataclass(frozen=True)
class CoTracker2Config:
    """The published settings (co-tracker v2.0's ``CoTracker2``)."""

    model_resolution: tuple = (384, 512)
    stride: int = 4
    latent_dim: int = 128
    hidden_size: int = 384
    num_heads: int = 8
    time_depth: int = 6
    space_depth: int = 6
    mlp_ratio: float = 4.0
    num_virtual_tracks: int = 64
    window_len: int = 8
    corr_levels: int = 4
    corr_radius: int = 3
    input_dim: int = 456
    iterations: int = 4
    dtype: torch.dtype = torch.float32  # compute dtype (or bfloat16)


def token_dim(cfg: CoTracker2Config) -> int:
    """Channels of a token: flow embedding, correlation, features, mask and
    visibility."""
    k = 2 * cfg.corr_radius + 1
    return (2 + 4 * FLOW_FREQUENCIES + cfg.corr_levels * k * k
            + cfg.latent_dim + 2)


def track_layout(n: int) -> tuple:
    """``(rows, cols)`` with ``rows * cols == n``, rows the largest divisor
    of ``n`` not above its square root: a square grid of queries lies as
    itself (50 x 50 for 2500), others as near a square as ``n`` allows."""
    rows = max(d for d in range(1, math.isqrt(max(n, 1)) + 1) if n % d == 0)
    return rows, max(n, 1) // rows


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """``[M, dim]``: sin then cos of ``pos [M]`` at frequencies
    ``10000^(-2i/dim)`` (computed in float64, returned float32)."""
    omega = torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0)
    out = pos.double().reshape(-1, 1) / 10000.0 ** omega
    return torch.cat([torch.sin(out), torch.cos(out)], 1).float()


def sincos_2d(dim: int, h: int, w: int) -> torch.Tensor:
    """``[h, w, dim]``: the release's 2D table, the first half of the
    channels from x, the second from y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    return torch.cat([sincos_1d(dim // 2, xs), sincos_1d(dim // 2, ys)],
                     1).reshape(h, w, dim)


def flow_embedding(flow: torch.Tensor) -> torch.Tensor:
    """``[..., 2 + 4 * 32]``: the flow itself, then for x and for y the
    interleaved sin and cos at frequencies ``k * 1000 / 64``, k < 32."""
    freqs = torch.arange(0, 2 * FLOW_FREQUENCIES, 2, dtype=torch.float32,
                         device=flow.device) * (500.0 / FLOW_FREQUENCIES)
    ang = flow[..., None] * freqs                     # [..., 2, 32]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], -1).flatten(-3)
    return torch.cat([flow, pe], -1)


def sample_border(table: torch.Tensor, xy: torch.Tensor,
                  index: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear samples of ``table [T, h, w, C]`` at ``xy [N, 2]`` pixel
    positions of map ``index [N]`` (0 if None), each position clamped into
    the map first (``grid_sample``'s border mode, ``align_corners=True``).
    Returns ``[N, C]`` in ``table``'s dtype."""
    t, h, w, c = table.shape
    x = xy[:, 0].clamp(0, w - 1)
    y = xy[:, 1].clamp(0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    base = 0 if index is None else index.clamp(0, t - 1) * (h * w)
    flat = table.reshape(t * h * w, c)

    def at(yi, xi):
        return flat[base + yi * w + xi]

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
            + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))


class Mlp(nn.Module):
    def __init__(self, features, hidden, dtype):
        super().__init__()
        self.fc1 = Dense(features, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, features, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """Multi-head attention with ``to_q``, ``to_kv`` (keys, then values) and
    ``to_out``; self-attention takes q, k and v from one product. ``bias``:
    an additive mask broadcastable to ``[B, heads, N1, N2]``."""

    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.heads = heads
        self.to_q = Dense(dim, dim, dtype=dtype)
        self.to_kv = Dense(dim, 2 * dim, dtype=dtype)
        self.to_out = Dense(dim, dim, dtype=dtype)

    def forward(self, x, context=None, bias=None):
        b, n1, c = x.shape
        h = self.heads
        if context is None:
            dt = self.to_q.compute_dtype
            qkv = F.linear(x.to(dt), torch.cat(
                [self.to_q.weight, self.to_kv.weight]).to(dt), torch.cat(
                [self.to_q.bias, self.to_kv.bias]).to(dt))
            q, k, v = qkv.view(b, n1, 3, h, c // h).permute(2, 0, 3, 1, 4)
        else:
            n2 = context.shape[1]
            q = self.to_q(x).view(b, n1, h, c // h).transpose(1, 2)
            k, v = self.to_kv(context).view(b, n2, 2, h, c // h).permute(
                2, 0, 3, 1, 4)
        out = _attend(q, k, v, bias)
        return self.to_out(out.transpose(1, 2).reshape(b, n1, c))


def _attend(q, k, v, bias):
    """Softmax attention of ``q [B, h, L1, d]`` over ``k``, ``v [B, h, L2,
    d]`` plus ``bias``: the fused kernel, but over at most ``SHORT_KEYS``
    keys (the time blocks' 8 frames), where it pads the keys to tiles of 64
    or more, the two products and a float32 softmax written out."""
    if k.shape[-2] > SHORT_KEYS:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    sim = torch.matmul(q, k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    if bias is not None:
        sim = sim + bias
    return torch.matmul(sim.softmax(-1).to(v.dtype), v)


def _norm(x):
    """LayerNorm without affine parameters, eps 1e-6 (float32 statistics)."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class AttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, dtype):
        super().__init__()
        self.attn = Attention(dim, heads, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(_norm(x))
        return x + self.mlp(_norm(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, dtype):
        super().__init__()
        self.norm_context = nn.LayerNorm(dim)
        self.cross_attn = Attention(dim, heads, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, context, bias=None):
        nc = self.norm_context
        ctx = F.layer_norm(context, context.shape[-1:],
                           nc.weight.to(context.dtype),
                           nc.bias.to(context.dtype), nc.eps)
        x = x + self.cross_attn(_norm(x), ctx, bias)
        return x + self.mlp(_norm(x))


def _mask_bias(mask, dtype, queries: int, keys: int, over_queries: bool):
    """The release's additive mask: ``-max`` where ``mask [S, N]`` is False,
    over the keys or (``over_queries``) over the queries; a contiguous
    ``[S, 1, queries, keys]`` (the fused attention reads its last dimension
    contiguous)."""
    if mask is None:
        return None
    bias = torch.zeros(mask.shape, dtype=dtype, device=mask.device)
    bias = bias.masked_fill(~mask, -torch.finfo(dtype).max)
    bias = bias[:, None, :, None] if over_queries else bias[:, None, None, :]
    return bias.expand(-1, 1, queries, keys).contiguous()


class EfficientUpdateFormer(nn.Module):
    """``forward(x [N, S, input_dim], mask [S, N] bool or None) -> [N, S,
    2 + latent_dim]`` float32.

    Where ``GraphCache.engages`` (on the card, autograd off, outside a
    stream capture), a call replays a CUDA graph of the former
    (``utils/graphs.py``; ~350 launches an iteration otherwise paced by the
    host), captured at the first call of its signature
    (``GraphCache.signature``). It returns the graph's own output, which
    the next call overwrites. The tracer counts
    ``cotracker2.former_graph.captures`` and ``.replays``. Every other call
    (the CPU) runs the former eagerly."""

    def __init__(self, cfg: CoTracker2Config):
        super().__init__()
        c, dt = cfg, cfg.dtype
        hid = c.hidden_size
        self.compute_dtype = dt
        self.num_virtual_tracks = c.num_virtual_tracks
        self.input_transform = Dense(c.input_dim, hid, dtype=dt)
        self.flow_head = Dense(hid, c.latent_dim + 2, dtype=dt)
        self.virual_tracks = nn.Parameter(
            torch.randn(1, c.num_virtual_tracks, 1, hid))
        self.time_blocks = nn.ModuleList(
            [AttnBlock(hid, c.num_heads, c.mlp_ratio, dt)
             for _ in range(c.time_depth)])
        self.space_virtual_blocks = nn.ModuleList(
            [AttnBlock(hid, c.num_heads, c.mlp_ratio, dt)
             for _ in range(c.space_depth)])
        self.space_point2virtual_blocks = nn.ModuleList(
            [CrossAttnBlock(hid, c.num_heads, c.mlp_ratio, dt)
             for _ in range(c.space_depth)])
        self.space_virtual2point_blocks = nn.ModuleList(
            [CrossAttnBlock(hid, c.num_heads, c.mlp_ratio, dt)
             for _ in range(c.space_depth)])
        self._graphs = GraphCache("cotracker2.former_graph", self)

    def forward(self, x, mask=None):
        inputs = (x,) if mask is None else (x, mask)
        if GraphCache.engages(inputs):
            return self._graphs(self._body, inputs)
        return self._body(x, mask)

    def _body(self, x, mask=None):
        dt = self.compute_dtype
        n, s = x.shape[:2]
        tokens = self.input_transform(x)
        virtual = self.virual_tracks.to(dt)[0].expand(-1, s, -1)
        tokens = torch.cat([tokens, virtual])                 # [N+V, S, D]
        v = self.num_virtual_tracks
        to_points = _mask_bias(mask, dt, v, n, over_queries=False)
        from_points = _mask_bias(mask, dt, n, v, over_queries=True)
        every = len(self.time_blocks) // len(self.space_virtual_blocks)
        j = 0
        for i, block in enumerate(self.time_blocks):
            tokens = block(tokens)
            if i % every:
                continue
            space = tokens.transpose(0, 1).contiguous()       # [S, N+V, D]
            point, virtual = space[:, :n], space[:, n:]
            virtual = self.space_virtual2point_blocks[j](virtual, point,
                                                         to_points)
            virtual = self.space_virtual_blocks[j](virtual)
            point = self.space_point2virtual_blocks[j](point, virtual,
                                                       from_points)
            tokens = torch.cat([point, virtual], 1).transpose(0, 1)
            tokens = tokens.contiguous()
            j += 1
        return self.flow_head(tokens[:n]).float()


class InstanceNorm(nn.Module):
    """Instance normalisation without affine parameters (eps 1e-5) on
    ``[B, H, W, C]``, statistics in float32, in the input's dtype."""

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), x.shape[-1], eps=1e-5)
        return y.permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, stride, dtype):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, dtype)
        self.norm1, self.norm2 = InstanceNorm(), InstanceNorm()
        self.downsample = (None if stride == 1 else nn.Sequential(
            Conv(in_planes, planes, 1, stride, dtype), InstanceNorm()))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """``[B, H, W, 3]`` in [-1, 1] -> ``[B, H/stride, W/stride, out]``."""

    def __init__(self, out_dim, stride, dtype):
        super().__init__()
        self.stride = stride
        half = out_dim // 2
        self.conv1 = Conv(3, half, 7, 2, dtype)
        self.norm1, self.norm2 = InstanceNorm(), InstanceNorm()
        widths = (half, out_dim // 4 * 3, out_dim, out_dim)
        in_planes = half
        for i, (w, s) in enumerate(zip(widths, (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(in_planes, w, s, dtype),
                ResidualBlock(w, w, 1, dtype)))
            in_planes = w
        self.conv2 = Conv(sum(widths), out_dim * 2, 3, 1, dtype)
        self.conv3 = Conv(out_dim * 2, out_dim, 1, 1, dtype)

    def forward(self, x):
        size = (x.shape[1] // self.stride, x.shape[2] // self.stride)
        x = F.relu(self.norm1(self.conv1(x)))
        stages = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            stages.append(F.interpolate(x.permute(0, 3, 1, 2), size,
                                        mode="bilinear", align_corners=True))
        x = torch.cat(stages, 1).permute(0, 2, 3, 1)
        return self.conv3(F.relu(self.norm2(self.conv2(x))))


@dataclasses.dataclass(frozen=True)
class OnlineState:
    """What :class:`CoTracker2Online` carries from one call to the next.

    ``queries [N, 3]`` (t, x, y) and ``query_frames`` (their t, on the
    host); ``frames``: the last ``window_len / 2`` frames handed in
    (``uint8 [k, H, W, 3]`` on the device); ``start``: the first frame of
    the next window; ``track_feat [N, C]``: the query points' features
    sampled so far (zero for a query whose frame has not come); ``coords``
    ``[k, N, 2]`` (pixels) and ``vis`` ``[k, N]`` (logits): the last
    window's predictions on the frames the next window shares with it, or
    None before the first window."""

    queries: torch.Tensor
    query_frames: np.ndarray
    frames: torch.Tensor
    start: int
    track_feat: torch.Tensor
    coords: torch.Tensor | None
    vis: torch.Tensor | None


class CoTracker2(nn.Module):
    """CoTracker2 on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"``), in ``eval()`` mode, its weights drawn with the
    release's initialisation from torch's global generator. The lookup goes
    through ``lookup_fn`` (``lookup_correlation_cuda`` in border mode).

    ``forward(video, queries)``: ``video [T, H, W, 3]`` RGB 0..255 at
    ``model_resolution`` (uint8 or float, tensor or numpy), ``queries [N,
    3]`` (t, x, y) in pixels; returns ``(tracks [T, N, 2], vis [T, N])``,
    float32 pixel positions and visibility logits (the release's predictor
    shows a point where ``sigmoid(vis) > 0.9``). A video shorter than a
    window is padded with its last frame, and so is its last window."""

    def __init__(self, cfg: CoTracker2Config = CoTracker2Config(),
                 device="cuda"):
        super().__init__()
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{cfg.dtype}")
        if cfg.input_dim != token_dim(cfg):
            raise ValueError(f"input_dim must be {token_dim(cfg)} at these "
                             f"widths, got {cfg.input_dim}")
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lookup_fn = lookup_correlation_cuda
        c, dt = cfg, cfg.dtype
        self.fnet = BasicEncoder(c.latent_dim, c.stride, dt)
        self.updateformer = EfficientUpdateFormer(c)
        self.norm = nn.GroupNorm(1, c.latent_dim)
        self.track_feat_updater = nn.Sequential(
            Dense(c.latent_dim, c.latent_dim, dtype=dt), nn.GELU())
        self.vis_predictor = nn.Sequential(Dense(c.latent_dim, 1, dtype=dt))
        h, w = (r // c.stride for r in c.model_resolution)
        self.register_buffer("pos_emb", sincos_2d(c.input_dim, h, w),
                             persistent=False)
        self.register_buffer("time_emb", sincos_1d(
            c.input_dim, torch.arange(c.window_len)), persistent=False)
        self._init_weights()
        self.to(self.device)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def _init_weights(self):
        """The release's: the encoder's convolutions kaiming-normal
        (fan_out, ReLU) with PyTorch's default biases; the former's linear
        layers xavier-uniform with zero biases, ``flow_head``'s weight
        normal with std 0.001 (truncated at +-2); the virtual tracks
        standard normal; the heads outside the former PyTorch's
        defaults."""
        for m in self.fnet.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")
        for m in self.updateformer.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.updateformer.flow_head.weight, std=0.001)

    # -- building blocks -----------------------------------------------------

    def encode(self, frames):
        """``uint8 [T, H, W, 3]`` frames on the device -> float32 feature
        maps ``[T, H/stride, W/stride, latent_dim]``."""
        c = self.cfg
        if tuple(frames.shape[1:]) != (*c.model_resolution, 3):
            raise ValueError(f"frames must be [T, {c.model_resolution[0]}, "
                             f"{c.model_resolution[1]}, 3], got "
                             f"{tuple(frames.shape)}")
        with span("cotracker2.encode"):
            count("cotracker2.frames_encoded", frames.shape[0])
            x = (2.0 * (frames.float() / 255.0) - 1.0).to(c.dtype)
            return self.fnet(x).float().contiguous()

    def _window(self, fmaps, coords, vis, track_feat, track_mask, attention):
        """One window: ``fmaps [S, h, w, C]``, ``coords [S, N, 2]`` (feature
        pixels), ``vis [S, N]`` logits, ``track_feat [S, N, C]``,
        ``track_mask [S, N]`` float, ``attention [S, N]`` bool or None (all
        true). Returns the last iteration's coords and the visibility
        logits."""
        c = self.cfg
        s, n = coords.shape[:2]
        rows, cols = track_layout(n)
        k = 2 * c.corr_radius + 1
        with span("cotracker2.window"):
            count("cotracker2.windows")
            count("cotracker2.tracks", n)
            pyr = [p.contiguous() for p in pool_feature_pyramid(
                fmaps, c.corr_levels)]
            static = (sample_border(self.pos_emb[None], coords[0])[:, None]
                      + self.time_emb)                        # [N, S, D]
            mask_vis = torch.stack([track_mask, vis], -1).transpose(0, 1)
            track_feat = track_feat.contiguous()
            for _ in range(c.iterations):
                with span("cotracker2.corr"):
                    corr = self.lookup_fn(
                        track_feat.view(s, rows, cols, -1), pyr,
                        coords.view(s, rows, cols, 2), c.corr_radius,
                        padding="border")
                corr = corr.view(s, n, c.corr_levels, k, k).transpose(-1, -2)
                x = torch.cat([flow_embedding((coords - coords[:1]).transpose(
                    0, 1)), corr.reshape(s, n, -1).transpose(0, 1),
                    track_feat.transpose(0, 1), mask_vis], -1) + static
                with span("cotracker2.former"):
                    delta = self.updateformer(x, attention)   # [N, S, 2+C]
                delta = delta.transpose(0, 1)
                coords = coords + delta[..., :2]
                d_feat = F.group_norm(delta[..., 2:].reshape(s * n, -1), 1,
                                      self.norm.weight, self.norm.bias,
                                      self.norm.eps)
                track_feat = track_feat + self.track_feat_updater(
                    d_feat).float().view(s, n, -1)
            return coords, self.vis_predictor(track_feat).float()[..., 0]

    def _window_inputs(self, q, qf, feat, start, prev_coords, prev_vis):
        """The release's set-up of the window that starts at frame
        ``start``: initial coords and visibility (from the previous
        window's predictions ``prev_coords [k, N, 2]`` pixels and
        ``prev_vis [k, N]`` on the shared frames, for the tracks queried
        before their end), the track features of the tracks queried by the
        window's end, the track mask and the attention mask (None where
        every track is queried by the window's end). ``q``: the queries on
        the device, ``qf`` their frames on the host, which decide what is
        launched (no value is copied to the device in a window)."""
        c = self.cfg
        s, n = c.window_len, q.shape[0]
        overlap = s - s // 2
        dev = q.device
        coords = (q[:, 1:] / c.stride).expand(s, n, 2)
        vis = torch.full((s, n), VIS_INIT, device=dev)
        qf_dev = q[:, 0].long()
        if start > 0:
            carried = qf_dev < start + overlap
            last = s - prev_coords.shape[0]
            pc = torch.cat([prev_coords, prev_coords[-1:].expand(last, n, 2)])
            pv = torch.cat([prev_vis, prev_vis[-1:].expand(last, n)])
            coords = torch.where(carried[:, None], pc / c.stride, coords)
            vis = torch.where(carried, pv, vis)
        frames = torch.arange(start, start + s, device=dev)
        track_mask = (qf_dev[None] <= frames[:, None]).float()
        if start > 0:
            track_mask[:overlap] = 0.0
        if (qf < start + s).all():
            return coords.contiguous(), vis, feat.expand(s, n, -1), \
                track_mask, None
        attention = qf_dev < start + s
        feat = feat * attention[:, None]
        return (coords.contiguous(), vis, feat.expand(s, n, -1), track_mask,
                attention.expand(s, n))

    def _frames(self, video):
        """Frames on the device, as ``uint8`` or float32."""
        frames = torch.as_tensor(video).to(self.device)
        return frames if frames.dtype == torch.uint8 else frames.float()

    def _queries(self, queries):
        """Queries on the device, and their frames on the host."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        return q.to(self.device), q[:, 0].long().cpu().numpy()

    # -- entry points ------------------------------------------------------

    def forward(self, video, queries):
        with torch.inference_mode(), full_float32(), span(
                "cotracker2.forward"):
            return self._offline(video, queries)

    def _offline(self, video, queries):
        c = self.cfg
        s, step = c.window_len, c.window_len // 2
        frames = self._frames(video)
        q, qf = self._queries(queries)
        t, n = frames.shape[0], q.shape[0]
        pad = (s - t % s) % s
        if pad:
            frames = torch.cat([frames, frames[-1:].expand(
                pad, *frames.shape[1:])])
        fmaps = self.encode(frames)
        feat = sample_border(fmaps, q[:, 1:] / c.stride, q[:, 0].long())
        tracks = torch.zeros((t, n, 2), device=self.device)
        vis = torch.zeros((t, n), device=self.device)
        windows = max(1, (t - s + step - 1) // step + 1)
        for start in range(0, step * windows, step):
            inputs = self._window_inputs(
                q, qf, feat, start, tracks[start:start + s - step],
                vis[start:start + s - step])
            coords, v = self._window(fmaps[start:start + s], *inputs)
            keep = min(t - start, s)
            tracks[start:start + keep] = coords[:keep] * c.stride
            vis[start:start + keep] = v[:keep]
        return tracks, vis


class CoTracker2Online:
    """The release's online predictor over a :class:`CoTracker2`.

    ``step(frames, queries)`` starts a clip: ``frames`` are its first
    ``window_len / 2`` frames (``[k, H, W, 3]``, RGB 0..255 at the model's
    resolution) and ``queries [N, 3]`` (t, x, y), t counted from the clip's
    first frame; nothing is tracked yet and it returns None.
    ``step(frames)`` then hands in the next ``k`` frames, runs the window
    of the last ``2k`` (re-encoding the ``k`` it shares with the window
    before, as the release does) and returns ``(tracks [2k, N, 2], vis [2k,
    N])``: float32 pixel positions and visibility logits on the window's
    frames ``state.start - k .. state.start + k - 1``. Each call is a span
    ``cotracker2.step``. ``state`` (:class:`OnlineState`) is replaced, never
    changed in place, by each call."""

    def __init__(self, model: CoTracker2):
        self.model = model
        self.state: OnlineState | None = None

    def step(self, frames, queries=None):
        m = self.model
        with torch.inference_mode(), full_float32(), span("cotracker2.step"):
            k = m.cfg.window_len // 2
            if len(frames) != k:
                raise ValueError(f"a call hands in {k} frames, got "
                                 f"{len(frames)}")
            frames = m._frames(frames)
            if queries is not None:
                q, qf = m._queries(queries)
                self.state = OnlineState(
                    q, qf, frames, 0,
                    torch.zeros((q.shape[0], m.cfg.latent_dim),
                                device=m.device), None, None)
                return None
            if self.state is None:
                raise ValueError("the first call of a clip gives queries")
            tracks, vis, self.state = self._window(self.state, frames)
            return tracks, vis

    def _window(self, st: OnlineState, new_frames):
        """The window over ``st.frames`` and ``new_frames``: the outputs
        and the next state."""
        m, c = self.model, self.model.cfg
        s = c.window_len
        fmaps = m.encode(torch.cat([st.frames, new_frames]))
        q, qf = st.queries, st.query_frames
        left = 0 if st.start == 0 else st.start + s // 2
        feat = st.track_feat
        if ((qf >= left) & (qf < st.start + s)).any():
            t = q[:, 0].long()
            sampled = sample_border(fmaps, q[:, 1:] / c.stride,
                                    t - st.start)
            new = (t >= left) & (t < st.start + s)
            feat = feat + sampled * new[:, None]
        coords, vis = m._window(fmaps, *m._window_inputs(
            q, qf, feat, st.start, st.coords, st.vis))
        tracks = coords * c.stride
        k = s // 2
        return tracks, vis, dataclasses.replace(
            st, frames=new_frames, start=st.start + k, track_feat=feat,
            coords=tracks[k:], vis=vis[k:])
