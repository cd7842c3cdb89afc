"""CoTracker-style joint point tracking over video, for inference and
training — the counterpart of ``feature_tracker_tpu/models/cotracker.py``.

N query points are tracked through T frames jointly, with a factorized
transformer attending across time (per point) and across points (per
frame), refining all tracks at once. Per iteration, each (point, frame)
token packs:
 - multi-scale correlation features: the query point's frame-0 feature
   dotted against a (2r+1)^2 window around the current estimate in that
   frame's (pooled) feature pyramid,
 - a sinusoidal embedding of the current flow from the query position,
 - the track's appearance feature (and, with ``time_encoding``, a
   sinusoidal encoding of the frame index).
The head predicts per-token position deltas and visibility logits.

Numerics kept from the Flax model: its stride-2 ``padding="SAME"``
convolutions pad asymmetrically (``SameConv``), the flow embedding's
reshape order, zero-padded bilinear sampling, and Flax's
``MultiHeadDotProductAttention`` (query scaled by 1/sqrt(head_dim) before
the product). The flow embedding's top frequencies reach 2^(dim/4 - 1), so
its high channels turn a last-bit difference of a flow into a different
angle: two implementations that round one product differently stop
agreeing in those channels from the second iteration on.

Submodules carry the Flax model's names (``FrameEncoder_0``,
``token_proj``, ``feat_proj``, ``update`` with ``time_{i}``, ``point_{i}``,
``delta_head``, ``vis_head``), so a weight file's leaf path is its
``state_dict`` key (``convert.py::cotracker_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    divide,
    gelu,
)
from feature_tracker_tpu_torch.models.raft import (
    Conv,
    full_float32,
    pool_feature_pyramid,
)


@dataclasses.dataclass(frozen=True)
class CoTrackerConfig:
    feature_dim: int = 64
    stride: int = 4               # feature-map downsampling
    corr_levels: int = 2
    corr_radius: int = 3
    model_dim: int = 128
    num_heads: int = 4
    depth: int = 2                # transformer blocks per refinement
    iterations: int = 4
    # Sinusoidal time encoding on the tokens (param-free). Off by
    # default: weights trained without it expect unshifted activations.
    time_encoding: bool = False
    dtype: torch.dtype = torch.float32


def _same_pads(size: int, kernel: int, stride: int):
    """``(low, high)`` padding of ``padding="SAME"`` (``lax.padtype_to_
    pads``): the output has ceil(size / stride) entries, and an odd total
    puts the extra row or column at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(Conv):
    """``Conv`` with Flax's ``padding="SAME"`` at any stride: for stride 2
    and an even size the padding is (2, 3) for a 7x7 kernel and (0, 1) for
    a 3x3 one, where torch's ``k // 2`` is symmetric."""

    def __init__(self, in_features, features, kernel, stride=1,
                 dtype=torch.float32):
        super().__init__(in_features, features, kernel, stride, dtype)
        self.padding = (0, 0)

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        top, bottom = _same_pads(x.shape[1], kh, sh)
        left, right = _same_pads(x.shape[2], kw, sw)
        return super().forward(F.pad(x, (0, 0, left, right, top, bottom)))


class FrameEncoder(nn.Module):
    """Small conv encoder, stride 4 (stride 2 applied twice)."""

    def __init__(self, dim: int, in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = SameConv(in_channels, dim // 2, 7, 2, dtype)
        self.Conv_1 = SameConv(dim // 2, dim, 3, 2, dtype)
        self.Conv_2 = SameConv(dim, dim, 3, 1, dtype)

    def forward(self, x):
        x = gelu(self.Conv_0(x))
        x = gelu(self.Conv_1(x))
        return self.Conv_2(x)


def _gather_rows(fmap, yi, xi):
    """Zero-padded row gather from ``fmap [B, h, w, C]`` at integer
    ``(yi, xi)`` of shape ``[B, ...]``; out-of-range reads 0. Returns
    ``[B, ..., C]``."""
    b, h, w, c = fmap.shape
    ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    flat = (torch.clamp(yi, 0, h - 1) * w
            + torch.clamp(xi, 0, w - 1)).reshape(b, -1)
    batch = torch.arange(b, device=fmap.device)[:, None]
    rows = fmap.reshape(b, h * w, c)[batch, flat].reshape(
        yi.shape + (c,))
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def _bilinear_rows(fmap, pos):
    """Zero-padded bilinear feature sample: fmap ``[B, h, w, C]``, pos
    ``[B, ..., 2]`` (x, y) in feature coords. Returns ``[B, ..., C]``."""
    x = pos[..., 0]
    y = pos[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    return ((1 - fy) * (1 - fx) * _gather_rows(fmap, y0i, x0i)
            + (1 - fy) * fx * _gather_rows(fmap, y0i, x0i + 1)
            + fy * (1 - fx) * _gather_rows(fmap, y0i + 1, x0i)
            + fy * fx * _gather_rows(fmap, y0i + 1, x0i + 1))


def _corr_features(track_feat, fpyrs, pos, radius: int):
    """Windowed correlation of each track's appearance feature against
    each frame's feature pyramid around the current positions.

    track_feat: [N, C]; fpyrs: list of [T, h, w, C]; pos: [T, N, 2]
    (feature coords at level 0). Returns [T, N, L*(2r+1)^2]."""
    d = torch.arange(-radius, radius + 1, dtype=pos.dtype, device=pos.device)
    dxx, dyy = torch.meshgrid(d, d, indexing="xy")
    offs = torch.stack([dxx.reshape(-1), dyy.reshape(-1)], -1)  # [K2, 2]
    c = track_feat.shape[-1]
    scale = 1.0 / torch.sqrt(torch.full((), float(c), dtype=pos.dtype,
                                        device=pos.device))
    tf = track_feat * scale
    out = []
    for lvl, fp in enumerate(fpyrs):
        p = divide(pos, 2.0 ** lvl)
        sample_pos = p[:, :, None, :] + offs[None, None, :, :]  # [T,N,K2,2]
        rows = _bilinear_rows(fp, sample_pos)                  # [T,N,K2,C]
        out.append(torch.einsum("nc,tnkc->tnk", tf, rows))
    return torch.cat(out, dim=-1)


def _flow_embedding(flow, dim: int):
    """Sinusoidal embedding of 2D flow, [..., dim] (dim multiple of 4)."""
    freqs = torch.exp2(torch.arange(dim // 4, dtype=flow.dtype,
                                    device=flow.device))
    ang = flow[..., :, None] * freqs * (math.pi / 64.0)  # [..., 2, dim/4]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(flow.shape[:-1] + (dim,))


class MultiHeadDotProductAttention(nn.Module):
    """Flax's self-attention over the second-to-last axis of ``[..., L, D]``:
    query, key, value and output projections (Flax's ``DenseGeneral``
    ``[D, H, Dh]`` / ``[H, Dh, D]`` kernels held as ``[H*Dh, D]`` /
    ``[D, H*Dh]`` weights), the query scaled by 1/sqrt(Dh)."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(dim, dim, dtype=dtype)
        self.value = Dense(dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        *lead, length, dim = x.shape
        dh = dim // self.heads

        def heads_of(a):
            return a.reshape(*lead, length, self.heads, dh)

        q = heads_of(self.query(x))
        q = q / torch.sqrt(torch.full((), float(dh), device=x.device)).to(
            q.dtype)
        k = heads_of(self.key(x))
        v = heads_of(self.value(x))
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        out = torch.einsum("...hqk,...khd->...qhd", w.to(v.dtype), v)
        return self.out(out.reshape(*lead, length, dim))


class AttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim, dtype=dtype)
        self.Dense_1 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = gelu(self.Dense_0(self.LayerNorm_1(x)))
        return x + self.Dense_1(h)


class FactorizedUpdate(nn.Module):
    """Time attention per track, then point attention per frame; returns
    (delta ``[T, N, 2]``, visibility logits ``[T, N]``) in float32."""

    def __init__(self, cfg: CoTrackerConfig):
        super().__init__()
        c = cfg
        self.depth = c.depth
        for i in range(c.depth):
            setattr(self, f"time_{i}",
                    AttnBlock(c.model_dim, c.num_heads, c.dtype))
            setattr(self, f"point_{i}",
                    AttnBlock(c.model_dim, c.num_heads, c.dtype))
        # Zero-initialised refinement heads: untrained, the tracker
        # predicts zero deltas and stays on the queries.
        self.delta_head = Dense(c.model_dim, 2, dtype=torch.float32)
        self.vis_head = Dense(c.model_dim, 1, dtype=torch.float32)
        for head in (self.delta_head, self.vis_head):
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)

    def forward(self, tokens):
        for i in range(self.depth):
            # Across time: each point attends over its own trajectory.
            x = getattr(self, f"time_{i}")(tokens.transpose(0, 1))
            tokens = x.transpose(0, 1)
            # Across points: joint reasoning within each frame.
            tokens = getattr(self, f"point_{i}")(tokens)
        return self.delta_head(tokens), self.vis_head(tokens)[..., 0]


class CoTracker(nn.Module):
    """Joint tracker. ``forward(video, queries)``: video ``[T, H, W, C]``
    (0..255), queries ``[N, 2]`` (x, y) on frame 0. Returns (tracks
    ``[T, N, 2]`` pixel coords, visibility logits ``[T, N]``), and with
    ``return_all_iterations`` also every iteration's positions
    ``[K, T, N, 2]``. Inputs may be numpy arrays or tensors; the model runs
    on ``device`` (default ``"cuda"``) in ``eval()`` mode, under
    ``torch.inference_mode`` unless ``grad=True`` (the trainer's form,
    ``train/cotracker_pretrain.py``: one clip per call, the batch of the
    JAX trainer's ``vmap`` a loop over calls)."""

    def __init__(self, cfg: CoTrackerConfig = CoTrackerConfig(),
                 in_channels: int = 1, device="cuda"):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.FrameEncoder_0 = FrameEncoder(c.feature_dim, in_channels,
                                           c.dtype)
        k2 = (2 * c.corr_radius + 1) ** 2
        emb_dim = (c.model_dim // 4) * 4
        self.token_proj = Dense(c.corr_levels * k2 + emb_dim, c.model_dim,
                                dtype=c.dtype)
        self.feat_proj = Dense(c.feature_dim, c.model_dim, dtype=c.dtype)
        self.update = FactorizedUpdate(c)
        self.to(self.device)
        self.eval()

    def forward(self, video, queries, return_all_iterations: bool = False,
                *, grad: bool = False):
        with torch.inference_mode(not grad), full_float32():
            ctx = self._prepare(video, queries)
            t, n = ctx["t"], ctx["n"]
            pos = ctx["q_feat_pos"][None, :, :].expand(t, n, 2)
            vis = torch.zeros((t, n), device=self.device)
            pos_iters = []
            for _ in range(self.cfg.iterations):
                pos, vis = self._refine(ctx, pos)
                pos_iters.append(pos)
            stride = self.cfg.stride
            if return_all_iterations:
                return pos * stride, vis, torch.stack(pos_iters) * stride
            return pos * stride, vis

    def refine_step(self, video, queries, tracks):
        """One refinement iteration from ``tracks [T, N, 2]`` (pixel
        coords; the queries repeated over T are the first iteration's
        start): (tracks ``[T, N, 2]``, visibility logits ``[T, N]``) after
        it. Holds one iteration of two implementations against each other
        from the same positions, which the flow embedding's high channels
        make necessary (see the module docstring)."""
        with torch.inference_mode(), full_float32():
            ctx = self._prepare(video, queries)
            tracks = torch.as_tensor(tracks, dtype=torch.float32,
                                     device=self.device)
            pos, vis = self._refine(ctx, divide(tracks,
                                                float(self.cfg.stride)))
            return pos * self.cfg.stride, vis

    def _prepare(self, video, queries):
        """What every iteration reads: the feature pyramids, the tracks'
        features and tokens, the query positions in feature coords."""
        c = self.cfg
        video = torch.as_tensor(video, dtype=torch.float32,
                                device=self.device)
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        t = video.shape[0]
        frames = (2.0 * divide(video, 255.0) - 1.0).to(c.dtype)
        fmaps = self.FrameEncoder_0(frames).float().contiguous()
        q_feat_pos = divide(queries, float(c.stride))          # [N, 2]
        track_feat = _bilinear_rows(fmaps[:1], q_feat_pos[None])[0]
        if c.time_encoding:
            ti = torch.arange(t, dtype=torch.float32,
                              device=self.device)[:, None]
            di = torch.arange(c.model_dim, dtype=torch.float32,
                              device=self.device)[None, :]
            ang = ti / torch.pow(100.0, divide(torch.floor(di / 2) * 2.0,
                                               float(c.model_dim)))
            time_tokens = torch.where(di % 2 == 0, torch.sin(ang),
                                      torch.cos(ang)).to(c.dtype)[:, None]
        else:
            time_tokens = torch.zeros((t, 1, c.model_dim), dtype=c.dtype,
                                      device=self.device)
        return {"t": t, "n": queries.shape[0],
                "fpyrs": pool_feature_pyramid(fmaps, c.corr_levels),
                "q_feat_pos": q_feat_pos, "track_feat": track_feat,
                "feat_tokens": self.feat_proj(track_feat)[None, :, :],
                "time_tokens": time_tokens}

    def _refine(self, ctx, pos):
        """One iteration from ``pos [T, N, 2]`` in feature coords: (new
        positions, visibility logits)."""
        c = self.cfg
        corr = _corr_features(ctx["track_feat"], ctx["fpyrs"], pos,
                              c.corr_radius)
        flow = pos - ctx["q_feat_pos"][None, :, :]
        tok = torch.cat([corr.to(c.dtype),
                         _flow_embedding(flow.to(c.dtype),
                                         (c.model_dim // 4) * 4)], dim=-1)
        tokens = (self.token_proj(tok) + ctx["feat_tokens"]
                  + ctx["time_tokens"])
        delta, vis = self.update(tokens)
        return pos + delta, vis
