"""Plain float32 reference of CoTracker2 inference, in plain torch.

The ``CoTracker2`` model of co-tracker's v2.0 release (Karaev et al.,
CoTracker: It is Better to Track Together, ECCV 2024, arXiv:2307.07635),
written out from its published formulation as functions of a weight dict
keyed by the release's parameter names (:func:`draw_weights` draws one with
the release's initialisation). It shares no code with the port and imports
none of it. Matrix products and convolutions run in float32 with TF32 off
(:func:`no_tf32`); ``fp8`` makes the control, every product's operands
(convolutions, linear layers, attention, the correlation) rounded to
float8 e4m3 with one scale per tensor.

As the release: the encoder is ``BasicEncoder`` with instance
normalisation; the correlation is each level's all-pairs volume
``matmul(track_feat, fmap) / sqrt(C)`` sampled by ``F.grid_sample(...,
padding_mode="border", align_corners=True)`` at ``coords / 2^l`` plus
offsets built as ``meshgrid(dy, dx, indexing="ij")`` added to (x, y) (so
the 7x7 samples are x-major); the token is ``[flow embedding, correlation,
track features, track mask, visibility] + sampled 2D position embedding +
time embedding``; the former, the track-feature update and the visibility
head follow the release's ``EfficientUpdateFormer``, ``AttnBlock``,
``CrossAttnBlock``, ``Attention`` and ``CoTracker2.forward_window``; the
windows (offline) and the online steps follow ``CoTracker2.forward``.

Departures from the release, each a choice where its code does not apply:
- the head size is ``hidden_size / num_heads`` (the release fixes 48, which
  is that ratio at its published widths and breaks at others);
- batch 1, and the query frames known on the host;
- online, a call returns the window's own frames (the release's predictor
  returns every frame so far) and the state is a dict replaced each call;
- offline, a video shorter than ``window_len / 2 + 1`` frames still gets
  one window (the release's count of windows is 0 there);
- the fixed sin-cos tables are computed in float64 and rounded to float32.

Weights (:func:`draw_weights`): the encoder's convolutions kaiming-normal
(fan_out, ReLU), their biases uniform in +-1/sqrt(fan_in) (PyTorch's
default); the former's linear layers xavier-uniform with zero biases,
``flow_head.weight`` normal with std 0.001 (the release truncates at +-2,
which a std of 0.001 never reaches); the virtual tracks standard normal;
the context LayerNorms and the GroupNorm the identity; the heads outside the
former PyTorch's default linear initialisation.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


# -- configuration and weights ----------------------------------------------

def _blocks(cfg):
    """(prefix, kind) of every attention block of the former."""
    out = [(f"updateformer.time_blocks.{i}", "attn")
           for i in range(cfg["time_depth"])]
    for j in range(cfg["space_depth"]):
        out += [(f"updateformer.space_virtual_blocks.{j}", "attn"),
                (f"updateformer.space_point2virtual_blocks.{j}", "cross"),
                (f"updateformer.space_virtual2point_blocks.{j}", "cross")]
    return out


def weight_shapes(cfg):
    """``{name: (shape, init)}`` of every parameter, in the release's names;
    ``init`` is ``"kaiming"``, ``"conv_bias"`` (with the fan-in),
    ``"xavier"``, ``"zeros"``, ``"ones"``, ``"flow_head"``, ``"randn"``,
    ``"default"`` / ``"default_bias"`` (PyTorch's linear default, with the
    fan-in)."""
    lat, hid = cfg["latent_dim"], cfg["hidden_size"]
    mlp = int(hid * cfg["mlp_ratio"])
    out = {}

    def conv(name, c_in, c_out, k):
        out[name + ".weight"] = ((c_out, c_in, k, k), ("kaiming",))
        out[name + ".bias"] = ((c_out,), ("conv_bias", c_in * k * k))

    def linear(name, c_in, c_out, init="xavier"):
        w = ("xavier",) if init == "xavier" else ("default", c_in)
        b = ("zeros",) if init == "xavier" else ("default_bias", c_in)
        out[name + ".weight"] = ((c_out, c_in), w)
        out[name + ".bias"] = ((c_out,), b)

    half = lat // 2
    conv("fnet.conv1", 3, half, 7)
    widths = (half, lat // 4 * 3, lat, lat)
    c_in = half
    for i, w in enumerate(widths):
        for b in range(2):
            p = f"fnet.layer{i + 1}.{b}"
            conv(p + ".conv1", c_in if b == 0 else w, w, 3)
            conv(p + ".conv2", w, w, 3)
            if b == 0 and i > 0:
                conv(p + ".downsample.0", c_in, w, 1)
        c_in = w
    conv("fnet.conv2", sum(widths), 2 * lat, 3)
    conv("fnet.conv3", 2 * lat, lat, 1)
    linear("updateformer.input_transform", cfg["input_dim"], hid)
    linear("updateformer.flow_head", hid, lat + 2)
    out["updateformer.flow_head.weight"] = ((lat + 2, hid), ("flow_head",))
    out["updateformer.virual_tracks"] = (
        (1, cfg["num_virtual_tracks"], 1, hid), ("randn",))
    for prefix, kind in _blocks(cfg):
        a = prefix + (".attn" if kind == "attn" else ".cross_attn")
        linear(a + ".to_q", hid, hid)
        linear(a + ".to_kv", hid, 2 * hid)
        linear(a + ".to_out", hid, hid)
        linear(prefix + ".mlp.fc1", hid, mlp)
        linear(prefix + ".mlp.fc2", mlp, hid)
        if kind == "cross":
            out[prefix + ".norm_context.weight"] = ((hid,), ("ones",))
            out[prefix + ".norm_context.bias"] = ((hid,), ("zeros",))
    out["norm.weight"] = ((lat,), ("ones",))
    out["norm.bias"] = ((lat,), ("zeros",))
    linear("track_feat_updater.0", lat, lat, "default")
    linear("vis_predictor.0", lat, 1, "default")
    return out


def draw_weights(cfg, seed, device):
    """The release's initialisation of every parameter, drawn on ``device``
    from ``seed`` (one generator, the names in sorted order)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, (shape, init) in sorted(weight_shapes(cfg).items()):
        t = torch.empty(shape, device=device)
        kind = init[0]
        if kind == "kaiming":
            fan_out = shape[0] * math.prod(shape[2:])
            t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
        elif kind == "xavier":
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            t.uniform_(-a, a, generator=gen)
        elif kind in ("conv_bias", "default", "default_bias"):
            a = 1.0 / math.sqrt(init[1])
            t.uniform_(-a, a, generator=gen)
        elif kind == "flow_head":
            t.normal_(0.0, 0.001, generator=gen)
        elif kind == "randn":
            t.normal_(0.0, 1.0, generator=gen)
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        out[name] = t
    return out


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def fp8_round(x):
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), back in float32."""
    amax = x.abs().max()
    if not bool(amax > 0):
        return x
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


# -- fixed embeddings --------------------------------------------------------

def sincos_1d(dim, pos):
    omega = torch.arange(dim // 2, dtype=torch.float64)
    omega /= dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = torch.einsum("m,d->md", pos.reshape(-1).double(), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).float()


def sincos_2d(dim, h, w):
    """``[1, dim, h, w]``, as the release's ``get_2d_sincos_pos_embed``."""
    grid_h = torch.arange(h, dtype=torch.float)
    grid_w = torch.arange(w, dtype=torch.float)
    grid = torch.stack(torch.meshgrid(grid_w, grid_h, indexing="xy"), dim=0)
    emb = torch.cat([sincos_1d(dim // 2, grid[0]),
                     sincos_1d(dim // 2, grid[1])], dim=1)
    return emb.reshape(1, h, w, dim).permute(0, 3, 1, 2)


def get_2d_embedding(xy, c=64):
    """``[B, N, 2] -> [B, N, 2 + 2c]``, the release's flow embedding."""
    b, n, _ = xy.shape
    x, y = xy[:, :, 0:1], xy[:, :, 1:2]
    div_term = (torch.arange(0, c, 2, device=xy.device, dtype=torch.float32)
                * (1000.0 / c)).reshape(1, 1, c // 2)
    pe_x = torch.zeros(b, n, c, device=xy.device)
    pe_y = torch.zeros(b, n, c, device=xy.device)
    pe_x[:, :, 0::2] = torch.sin(x * div_term)
    pe_x[:, :, 1::2] = torch.cos(x * div_term)
    pe_y[:, :, 0::2] = torch.sin(y * div_term)
    pe_y[:, :, 1::2] = torch.cos(y * div_term)
    return torch.cat([xy, pe_x, pe_y], dim=2)


def bilinear_sampler(inp, coords, padding_mode="border"):
    """The release's: ``coords`` in pixels ((x, y), or (t, x, y) for a 5D
    input), ``align_corners=True``."""
    sizes = inp.shape[2:]
    if len(sizes) == 3:
        coords = coords[..., [1, 2, 0]]
    scale = torch.tensor([2 / max(size - 1, 1) for size in reversed(sizes)],
                         device=coords.device)
    return F.grid_sample(inp, coords * scale - 1, align_corners=True,
                         padding_mode=padding_mode)


# -- the model ---------------------------------------------------------------

class CoTracker2Reference:
    """Plain CoTracker2 from a weight dict (:func:`draw_weights`, or a
    ``state_dict`` of the release's names) and a configuration dict (the
    keys of ``CoTracker2Config``)."""

    def __init__(self, weights, cfg, device, fp8=False):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.fp8 = fp8
        self.w = {k: torch.as_tensor(v, dtype=torch.float32).to(self.dev)
                  for k, v in weights.items()}
        s = cfg["window_len"]
        self.time_emb = sincos_1d(
            cfg["input_dim"], torch.linspace(0, s - 1, s))[None].to(self.dev)

    def _q(self, x):
        return fp8_round(x) if self.fp8 else x

    def linear(self, x, name):
        return F.linear(self._q(x), self._q(self.w[name + ".weight"]),
                        self.w[name + ".bias"])

    def conv(self, x, name, stride=1):
        wt = self.w[name + ".weight"]
        return F.conv2d(self._q(x), self._q(wt), self.w[name + ".bias"],
                        stride, wt.shape[-1] // 2)

    # encoder, on [T, C, H, W]

    @staticmethod
    def inorm(x):
        return F.instance_norm(x, eps=1e-5)

    def block(self, x, p, stride):
        y = F.relu(self.inorm(self.conv(x, p + ".conv1", stride)))
        y = F.relu(self.inorm(self.conv(y, p + ".conv2")))
        if stride != 1:
            x = self.inorm(self.conv(x, p + ".downsample.0", stride))
        return F.relu(x + y)

    def fnet(self, x):
        _, _, h, w = x.shape
        st = self.cfg["stride"]
        x = F.relu(self.inorm(self.conv(x, "fnet.conv1", 2)))
        outs = []
        for i, stride in enumerate((1, 2, 2, 2)):
            x = self.block(x, f"fnet.layer{i + 1}.0", stride)
            x = self.block(x, f"fnet.layer{i + 1}.1", 1)
            outs.append(F.interpolate(x, (h // st, w // st), mode="bilinear",
                                      align_corners=True))
        x = F.relu(self.inorm(self.conv(torch.cat(outs, 1), "fnet.conv2")))
        return self.conv(x, "fnet.conv3")

    def encode(self, frames):
        """``[T, H, W, 3]`` 0..255 -> ``[T, C, H/4, W/4]``."""
        x = torch.as_tensor(frames).to(self.dev).float().permute(0, 3, 1, 2)
        return self.fnet(2 * (x / 255.0) - 1.0)

    # former, on [B, N, T, D]

    def attention(self, x, name, context=None, attn_bias=None):
        b, n1, c = x.shape
        h = self.cfg["num_heads"]
        d = c // h
        q = self.linear(x, name + ".to_q").reshape(b, n1, h, d).permute(
            0, 2, 1, 3)
        context = x if context is None else context
        k, v = self.linear(context, name + ".to_kv").chunk(2, dim=-1)
        n2 = context.shape[1]
        k = k.reshape(b, n2, h, d).permute(0, 2, 1, 3)
        v = v.reshape(b, n2, h, d).permute(0, 2, 1, 3)
        sim = (self._q(q) @ self._q(k).transpose(-2, -1)) * d ** -0.5
        if attn_bias is not None:
            sim = sim + attn_bias
        attn = sim.softmax(dim=-1)
        out = (self._q(attn) @ self._q(v)).transpose(1, 2).reshape(b, n1, c)
        return self.linear(out, name + ".to_out")

    def mlp(self, x, name):
        return self.linear(F.gelu(self.linear(x, name + ".fc1"),
                                  approximate="tanh"), name + ".fc2")

    @staticmethod
    def norm(x):
        return F.layer_norm(x, x.shape[-1:], eps=1e-6)

    def attn_block(self, x, p):
        x = x + self.attention(self.norm(x), p + ".attn")
        return x + self.mlp(self.norm(x), p + ".mlp")

    def cross_block(self, x, context, p, mask=None):
        attn_bias = None
        heads = self.cfg["num_heads"]
        if mask is not None:
            if mask.shape[1] == x.shape[1]:
                mask = mask[:, None, :, None].expand(-1, heads, -1,
                                                     context.shape[1])
            else:
                mask = mask[:, None, None].expand(-1, heads, x.shape[1], -1)
            attn_bias = (~mask) * -torch.finfo(x.dtype).max
        ctx = F.layer_norm(context, context.shape[-1:],
                           self.w[p + ".norm_context.weight"],
                           self.w[p + ".norm_context.bias"], 1e-5)
        x = x + self.attention(self.norm(x), p + ".cross_attn", ctx,
                               attn_bias)
        return x + self.mlp(self.norm(x), p + ".mlp")

    def updateformer(self, x, mask):
        cfg = self.cfg
        nv = cfg["num_virtual_tracks"]
        tokens = self.linear(x, "updateformer.input_transform")
        b, _, t, _ = tokens.shape
        virtual = self.w["updateformer.virual_tracks"].repeat(b, 1, t, 1)
        tokens = torch.cat([tokens, virtual], dim=1)
        _, n, _, _ = tokens.shape
        j = 0
        every = cfg["time_depth"] // cfg["space_depth"]
        for i in range(cfg["time_depth"]):
            time_tokens = tokens.contiguous().view(b * n, t, -1)
            time_tokens = self.attn_block(
                time_tokens, f"updateformer.time_blocks.{i}")
            tokens = time_tokens.view(b, n, t, -1)
            if i % every == 0:
                space = tokens.permute(0, 2, 1, 3).contiguous().view(
                    b * t, n, -1)
                point, virtual = space[:, :n - nv], space[:, n - nv:]
                virtual = self.cross_block(
                    virtual, point,
                    f"updateformer.space_virtual2point_blocks.{j}", mask)
                virtual = self.attn_block(
                    virtual, f"updateformer.space_virtual_blocks.{j}")
                point = self.cross_block(
                    point, virtual,
                    f"updateformer.space_point2virtual_blocks.{j}", mask)
                space = torch.cat([point, virtual], dim=1)
                tokens = space.view(b, t, n, -1).permute(0, 2, 1, 3)
                j += 1
        return self.linear(tokens[:, :n - nv], "updateformer.flow_head")

    # correlation

    def corr_sample(self, pyramid, targets, coords):
        """``pyramid``: ``[S, C, h_l, w_l]`` per level; ``targets [S, N,
        C]``; ``coords [S, N, 2]`` -> ``[S, N, L (2r+1)^2]``."""
        r = self.cfg["corr_radius"]
        s, n, c = targets.shape
        out = []
        for i, fmaps in enumerate(pyramid):
            h, w = fmaps.shape[-2:]
            corrs = torch.matmul(self._q(targets),
                                 self._q(fmaps).view(s, c, h * w))
            corrs = corrs.view(s, n, h, w) / torch.sqrt(
                torch.tensor(c).float())
            dx = torch.linspace(-r, r, 2 * r + 1)
            dy = torch.linspace(-r, r, 2 * r + 1)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"),
                                dim=-1).to(self.dev)
            centroid = coords.reshape(s * n, 1, 1, 2) / 2 ** i
            coords_lvl = centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
            sampled = bilinear_sampler(corrs.reshape(s * n, 1, h, w),
                                       coords_lvl, padding_mode="border")
            out.append(sampled.view(s, n, -1))
        return torch.cat(out, dim=-1)

    def forward_window(self, fmaps, coords, track_feat, vis, track_mask,
                       attention_mask):
        """The release's ``forward_window`` at batch 1: ``fmaps [S, C, h,
        w]``, ``coords [S, N, 2]`` (feature pixels), ``track_feat [S, N,
        C]``, ``vis``, ``track_mask [S, N, 1]``, ``attention_mask [S, N]``
        bool. Returns the last iteration's coords (feature pixels) and the
        visibility logits ``[S, N]``."""
        cfg = self.cfg
        s, n, _ = coords.shape
        lat = cfg["latent_dim"]
        track_mask_vis = torch.cat([track_mask, vis], dim=-1).permute(1, 0, 2)
        pyramid = [fmaps]
        for _ in range(cfg["corr_levels"] - 1):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
        h, w = fmaps.shape[-2:]
        pos = bilinear_sampler(sincos_2d(cfg["input_dim"], h, w).to(self.dev),
                               coords[0][None, None])       # [1, D, 1, N]
        pos = pos[0, :, 0].t()[:, None]                      # [N, 1, D]
        for _ in range(cfg["iterations"]):
            fcorrs = self.corr_sample(pyramid, track_feat, coords).permute(
                1, 0, 2)
            flows = (coords - coords[0:1]).permute(1, 0, 2)
            flow_emb = get_2d_embedding(flows, 64)
            tf = track_feat.permute(1, 0, 2)
            x = torch.cat([flow_emb, fcorrs, tf, track_mask_vis], dim=2)
            x = x + pos + self.time_emb
            delta = self.updateformer(x[None], attention_mask)[0]
            coords = coords + delta[..., :2].permute(1, 0, 2)
            d_feat = delta[..., 2:].permute(1, 0, 2).reshape(s * n, lat)
            d_feat = F.group_norm(d_feat, 1, self.w["norm.weight"],
                                  self.w["norm.bias"], 1e-5)
            track_feat = track_feat + F.gelu(self.linear(
                d_feat, "track_feat_updater.0")).reshape(s, n, lat)
        vis = self.linear(track_feat, "vis_predictor.0")[..., 0]
        return coords, vis

    def track_features(self, fmaps, frames_, coords):
        """The release's ``get_track_feat``: ``fmaps [T, C, h, w]``, query
        frames ``[N]`` and feature-pixel coords ``[N, 2]`` -> ``[N, C]``."""
        pts = torch.cat([frames_[:, None].float(), coords], -1)
        vol = fmaps.permute(1, 0, 2, 3)[None]              # [1, C, T, h, w]
        feats = bilinear_sampler(vol, pts[None, None, :, None])
        return feats[0, :, 0, :, 0].t()

    def window_setup(self, qf, qxy, ind, coords_prev, vis_prev):
        """Initial coords ``[S, N, 2]`` and visibility ``[S, N, 1]`` of the
        window at ``ind``, its track mask ``[S, N, 1]`` and attention mask
        ``[S, N]``; ``coords_prev`` / ``vis_prev``: the previous window's
        predictions (pixels, logits) on the frames the two share."""
        s = self.cfg["window_len"]
        step = s // 2
        n = qxy.shape[0]
        coords = qxy.reshape(1, n, 2).expand(s, n, 2).float()
        vis = torch.ones((s, n, 1), device=self.dev) * 10
        if ind > 0:
            overlap = s - step
            copy_over = (qf < ind + overlap)[None, :, None]
            cp = F.pad((coords_prev / self.cfg["stride"]).permute(1, 2, 0),
                       (0, step), "replicate").permute(2, 0, 1)
            vp = F.pad(vis_prev[..., None].permute(1, 2, 0), (0, step),
                       "replicate").permute(2, 0, 1)
            coords = torch.where(copy_over.expand_as(coords), cp, coords)
            vis = torch.where(copy_over.expand_as(vis), vp, vis)
        attention = (qf < ind + s).reshape(1, n).repeat(s, 1)
        track_mask = (qf[None, :, None] <= torch.arange(
            ind, ind + s, device=self.dev)[:, None, None]).contiguous()
        if ind > 0:
            track_mask[:s - step] = False
        return coords, vis, track_mask.float(), attention

    # entry points

    @torch.no_grad()
    def offline(self, video, queries):
        """``video [T, H, W, 3]``, ``queries [N, 3]`` (t, x, y pixels) ->
        tracks ``[T, N, 2]`` (pixels) and visibility logits ``[T, N]``."""
        cfg = self.cfg
        s, st = cfg["window_len"], cfg["stride"]
        step = s // 2
        with no_tf32():
            frames = torch.as_tensor(video).to(self.dev)
            t = frames.shape[0]
            pad = (s - t % s) % s
            frames = torch.cat([frames, frames[-1:].repeat(pad, 1, 1, 1)])
            fmaps = self.encode(frames)
            q = torch.as_tensor(queries, dtype=torch.float32).to(self.dev)
            qf, qxy = q[:, 0].long(), q[:, 1:] / st
            n = q.shape[0]
            feat = self.track_features(fmaps, qf, qxy)
            tracks = torch.zeros((t, n, 2), device=self.dev)
            vis = torch.zeros((t, n), device=self.dev)
            windows = max(1, (t - s + step - 1) // step + 1)
            for ind in range(0, step * windows, step):
                coords, v0, track_mask, attention = self.window_setup(
                    qf, qxy, ind, tracks[ind:ind + step],
                    vis[ind:ind + step])
                coords, v = self.forward_window(
                    fmaps[ind:ind + s], coords,
                    attention[..., None] * feat[None], v0, track_mask,
                    attention)
                keep = min(t - ind, s)
                tracks[ind:ind + keep] = coords[:keep] * st
                vis[ind:ind + keep] = v[:keep]
            return tracks, vis

    def online_start(self, queries, frames):
        """The state after a clip's first call (its first ``window_len / 2``
        frames and the queries)."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.dev)
        return {"queries": q, "frames": torch.as_tensor(frames).to(self.dev),
                "start": 0, "coords": None, "vis": None,
                "track_feat": torch.zeros((q.shape[0],
                                           self.cfg["latent_dim"]),
                                          device=self.dev)}

    @torch.no_grad()
    def online_step(self, state, frames):
        """One call of the release's online mode from ``state`` (see
        :meth:`online_start`) with the next ``window_len / 2`` frames:
        ``(tracks [S, N, 2], vis [S, N])`` on the window's frames, and the
        next state."""
        cfg = self.cfg
        s, st = cfg["window_len"], cfg["stride"]
        step = s // 2
        ind = state["start"]
        with no_tf32():
            chunk = torch.cat([state["frames"],
                               torch.as_tensor(frames).to(self.dev)])
            fmaps = self.encode(chunk)
            q = state["queries"]
            qf, qxy = q[:, 0].long(), q[:, 1:] / st
            feat = self.track_features(fmaps, qf - ind, qxy)
            left = 0 if ind == 0 else ind + step
            sample_mask = ((qf >= left) & (qf < ind + s))[:, None]
            feat = state["track_feat"] + feat * sample_mask
            coords, v0, track_mask, attention = self.window_setup(
                qf, qxy, ind, state["coords"], state["vis"])
            coords, vis = self.forward_window(
                fmaps, coords, attention[..., None] * feat[None], v0,
                track_mask, attention)
            tracks = coords * st
        new = {"queries": q, "frames": chunk[step:], "start": ind + step,
               "coords": tracks[step:], "vis": vis[step:],
               "track_feat": feat}
        return (tracks, vis), new
