"""Plain float32 reference of RAFT inference, in plain torch.

It takes a weight tree drawn from the seed (:func:`draw_weights`, laid out
by :func:`weight_layout` from the configuration alone) and computes the
model the port's ``models/raft.py`` and the JAX package's ``models/raft.py``
define, written out from those equations and sharing no code with them:

- input ``2 * (gray / 255) - 1``;
- two encoders of one trunk (7x7 stem, six residual blocks with batch
  normalisation by the running statistics, stride 2 in blocks 1, 3, 5, a 3x3
  head, ReLU throughout): features of both images, context of the first,
  split into the update block's input (first ``context_channels``) and the
  hidden state;
- the all-pairs correlation volume ``<f0, f1> / sqrt(C)`` with a 2x2-mean
  pyramid, sampled bilinearly with zero padding in ``(2r+1)^2`` windows
  (dy-major, dx-minor) around ``locations / 2^level``;
- the update block (motion encoder, separable ConvGRU 1x5 then 5x1, flow
  and mask heads, the mask scaled by 0.25), ``max_iterations`` times;
- the convex 8x upsampling of the last flow (``upsample_last_only``).

Convolutions and products run in float32 with TF32 off. ``fp8`` makes the
control: every convolution's input and weight, and the feature maps before
the correlation, rounded to float8 e4m3 with one scale per tensor.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def _encoder_layout(name, c_in, c_out):
    step = c_out // 4
    widths = (step, step, step * 2, step * 2, step * 3, step * 3, c_out)
    out = [((name, "Conv_0"), 7, 7, c_in, step)]
    for i in range(6):
        ci, co = widths[i], widths[i + 1]
        block = (name, f"ResNetBlock_{i}")
        out += [(block + ("Conv_0",), 3, 3, ci, co),
                (block + ("BatchNorm_0",), co),
                (block + ("Conv_1",), 3, 3, co, co),
                (block + ("BatchNorm_1",), co)]
        if i % 2 == 1 or ci != co:
            out += [(block + ("Conv_2",), 1, 1, ci, co),
                    (block + ("BatchNorm_2",), co)]
    return out + [((name, "Conv_1"), 3, 3, c_out, c_out)]


def weight_layout(cfg):
    """Every module of the model with weights, from the configuration
    alone: ``(path, kh, kw, c_in, c_out)`` for a convolution (kernel
    ``[kh, kw, c_in, c_out]`` and bias ``[c_out]``), ``(path, c)`` for a
    batch normalisation."""
    k = 2 * cfg["correlation_radius"] + 1
    ch = cfg["correlation_hidden_channels"]
    co = cfg["correlation_out_channels"]
    fh, fo = cfg["flow_hidden_channels"], cfg["flow_out_channels"]
    mo, hid = cfg["motion_out_channels"], cfg["hidden_channels"]
    mh = cfg["mask_hidden_channels"]
    x_in = cfg["context_channels"] + mo + hid
    ub = ("UpdateBlock_0",)
    me, gru = ub + ("MotionEncoder_0",), ub + ("SepConvGru_0",)
    corr_in = cfg["correlation_pyramid_levels"] * k * k
    update = [(me + ("Conv_0",), 1, 1, corr_in, ch),
              (me + ("Conv_1",), 3, 3, ch, co),
              (me + ("Conv_2",), 7, 7, 2, fh),
              (me + ("Conv_3",), 3, 3, fh, fo),
              (me + ("Conv_4",), 3, 3, co + fo, mo - 2)]
    for d, (kh, kw) in (("h", (1, 5)), ("v", (5, 1))):
        update += [(gru + (f"conv_{g}_{d}",), kh, kw, x_in, hid)
                   for g in "zrq"]
    update += [(ub + ("flow_conv1",), 3, 3, hid, fo),
               (ub + ("flow_conv2",), 3, 3, fo, 2),
               (ub + ("mask_hidden",), 3, 3, hid, mh),
               (ub + ("mask_out",), 1, 1, mh, 8 * 8 * 9)]
    return (_encoder_layout("feature_enc", cfg["in_channels"],
                            cfg["feature_channels"])
            + _encoder_layout("context_enc", cfg["in_channels"],
                              cfg["context_channels"] + cfg["hidden_channels"])
            + update)


def draw_weights(cfg, seed, device):
    """The weight tree ``{"params": ..., "batch_stats": ...}`` (nested dicts
    of float32 tensors, kernels ``[kh, kw, in, out]``) of an untrained
    model, drawn on ``device`` from ``seed`` in one call: every kernel and
    bias normal with the variance of PyTorch's default initialisation of a
    convolution, 1 / (3 fan-in), every batch normalisation the
    identity."""
    layout = weight_layout(cfg)
    convs = [e for e in layout if len(e) == 5]
    sizes = [kh * kw * ci * co + co for _, kh, kw, ci, co in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree = {"params": {}, "batch_stats": {}}

    def put(collection, path, leaves):
        node = tree[collection]
        for part in path:
            node = node.setdefault(part, {})
        node.update(leaves)

    offset = 0
    for (path, kh, kw, ci, co), n in zip(convs, sizes):
        v = flat[offset:offset + n] / math.sqrt(3 * kh * kw * ci)
        offset += n
        put("params", path, {"kernel": v[:-co].view(kh, kw, ci, co),
                             "bias": v[-co:]})
    for path, c in (e for e in layout if len(e) == 2):
        one = torch.ones(c, device=device)
        zero = torch.zeros(c, device=device)
        put("params", path, {"scale": one, "bias": zero})
        put("batch_stats", path, {"mean": zero, "var": one})
    return tree


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


class RaftReference:
    """Plain RAFT inference from a weight tree (``draw_weights``) and a
    configuration dict (``RaftConfig``'s field names)."""

    def __init__(self, tree, cfg, device, fp8=False):
        self.cfg = cfg
        self.fp8 = fp8
        self.dev = torch.device(device)

        def to_dev(node):
            if isinstance(node, dict):
                return {k: to_dev(v) for k, v in node.items()}
            return torch.as_tensor(node, dtype=torch.float32,
                                   device=self.dev)

        self.p = to_dev(tree["params"])
        self.s = to_dev(tree["batch_stats"])
        self.fitting = False

    # -- layers on [B, C, H, W] ---------------------------------------------

    def _q(self, x):
        return fp8_round(x) if self.fp8 else x

    def conv(self, x, leaf, stride=1):
        k = leaf["kernel"]                       # [kh, kw, in, out]
        kh, kw = k.shape[0], k.shape[1]
        w = k.permute(3, 2, 0, 1)
        if kh == 1 and kw == 1 and stride != 1:
            x, stride = x[:, :, ::stride, ::stride], 1
        return F.conv2d(self._q(x), self._q(w), leaf["bias"], stride,
                        (kh // 2, kw // 2))

    def bn(self, x, leaf, stats):
        if self.fitting:
            stats["mean"] = x.mean((0, 2, 3))
            stats["var"] = x.var((0, 2, 3), unbiased=False)
        mul = torch.rsqrt(stats["var"] + 1e-5) * leaf["scale"]
        return ((x - stats["mean"][None, :, None, None])
                * mul[None, :, None, None] + leaf["bias"][None, :, None, None])

    def encoder(self, x, name):
        p, s = self.p[name], self.s[name]
        x = F.relu(self.conv(x, p["Conv_0"]))
        for i in range(6):
            bp, bs = p[f"ResNetBlock_{i}"], s[f"ResNetBlock_{i}"]
            stride = 1 + i % 2
            h = F.relu(self.bn(self.conv(x, bp["Conv_0"], stride),
                               bp["BatchNorm_0"], bs["BatchNorm_0"]))
            h = self.bn(self.conv(h, bp["Conv_1"]), bp["BatchNorm_1"],
                        bs["BatchNorm_1"])
            if "Conv_2" in bp:
                x = self.bn(self.conv(x, bp["Conv_2"], stride),
                            bp["BatchNorm_2"], bs["BatchNorm_2"])
            x = F.relu(h + x)
        return F.relu(self.conv(x, p["Conv_1"]))

    # -- correlation ----------------------------------------------------------

    def corr_pyramid(self, f0, f1):
        """All-pairs volumes ``[B*H*W, 1, h_l, w_l]`` (level 0 first)."""
        b, c, h, w = f0.shape
        a = self._q(f0).flatten(2).transpose(1, 2)          # [B, HW, C]
        m = self._q(f1).flatten(2)                          # [B, C, HW]
        vol = (torch.bmm(a, m) / math.sqrt(c)).reshape(b * h * w, 1, h, w)
        pyr = [vol]
        for _ in range(self.cfg["correlation_pyramid_levels"] - 1):
            pyr.append(F.avg_pool2d(pyr[-1], 2, 2))
        return pyr

    def lookup(self, pyr, locs):
        """``[B, L*(2r+1)^2, H, W]`` windows around ``locs [B, H, W, 2]``."""
        b, h, w, _ = locs.shape
        r = self.cfg["correlation_radius"]
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=self.dev)
        dy, dx = torch.meshgrid(d, d, indexing="ij")          # dy-major
        offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)
        out = []
        for lvl, vol in enumerate(pyr):
            hl, wl = vol.shape[-2:]
            pos = locs.reshape(b * h * w, 1, 1, 2) / 2 ** lvl + offs[
                None, None]                                   # [M,1,K,2]
            grid = torch.stack([2 * pos[..., 0] / max(wl - 1, 1) - 1,
                                2 * pos[..., 1] / max(hl - 1, 1) - 1], -1)
            val = F.grid_sample(vol, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            out.append(val.reshape(b, h, w, -1))
        return torch.cat(out, -1).permute(0, 3, 1, 2)

    # -- update block ---------------------------------------------------------

    def update(self, net, inp, corr, flow):
        p = self.p["UpdateBlock_0"]
        me = p["MotionEncoder_0"]
        c = F.relu(self.conv(F.relu(self.conv(corr, me["Conv_0"])),
                             me["Conv_1"]))
        f = F.relu(self.conv(F.relu(self.conv(flow, me["Conv_2"])),
                             me["Conv_3"]))
        motion = torch.cat([F.relu(self.conv(torch.cat([c, f], 1),
                                             me["Conv_4"])), flow], 1)
        x = torch.cat([inp, motion], 1)
        g = p["SepConvGru_0"]
        for d in "hv":
            xh = torch.cat([x, net], 1)
            z = torch.sigmoid(self.conv(xh, g[f"conv_z_{d}"]))
            r = torch.sigmoid(self.conv(xh, g[f"conv_r_{d}"]))
            q = torch.tanh(self.conv(torch.cat([x, r * net], 1),
                                     g[f"conv_q_{d}"]))
            net = (1 - z) * net + z * q
        delta = self.conv(F.relu(self.conv(net, p["flow_conv1"])),
                          p["flow_conv2"])
        mask = 0.25 * self.conv(F.relu(self.conv(net, p["mask_hidden"])),
                                p["mask_out"])
        return net, mask, delta

    @staticmethod
    def upsample(flow, mask):
        """``flow [B, 2, H, W]``, ``mask [B, 576, H, W]`` -> ``[B, 8H, 8W,
        2]``."""
        b, _, h, w = flow.shape
        m = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), dim=1)
        nb = F.unfold(8.0 * flow, 3, padding=1).reshape(b, 2, 9, 1, 1, h, w)
        up = (m[:, None] * nb).sum(2)                      # [B, 2, 8, 8, H, W]
        return up.permute(0, 4, 2, 5, 3, 1).reshape(b, 8 * h, 8 * w, 2)

    # -- forward --------------------------------------------------------------

    def images(self, *frames_u8):
        """``[B, H, W, C]`` gray values as ``[B, C, H, W]`` in [-1, 1]."""
        return [2.0 * (torch.as_tensor(np.asarray(a)).to(
            self.dev, torch.float32).permute(0, 3, 1, 2) / 255.0) - 1.0
            for a in frames_u8]

    @torch.no_grad()
    def __call__(self, ref_u8, cur_u8):
        """``ref_u8``, ``cur_u8``: ``[B, H, W, C]`` gray values (uint8
        numpy or tensor). Returns the flow ``[B, H, W, 2]`` float32."""
        cfg = self.cfg
        with no_tf32():
            ref, cur = self.images(ref_u8, cur_u8)
            f0 = self.encoder(ref, "feature_enc")
            f1 = self.encoder(cur, "feature_enc")
            ctx = self.encoder(ref, "context_enc")
            cc = cfg["context_channels"]
            inp, net = ctx[:, :cc], ctx[:, cc:]
            pyr = self.corr_pyramid(f0, f1)
            b, _, h, w = f0.shape
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=self.dev),
                torch.arange(w, dtype=torch.float32, device=self.dev),
                indexing="ij")
            ref_locs = torch.stack([xs, ys], -1)[None].expand(b, h, w, 2)
            locs = ref_locs
            for _ in range(cfg["max_iterations"]):
                corr = self.lookup(pyr, locs)
                flow = (locs - ref_locs).permute(0, 3, 1, 2)
                net, mask, delta = self.update(net, inp, corr, flow)
                locs = locs + delta.permute(0, 2, 3, 1)
            return self.upsample((locs - ref_locs).permute(0, 3, 1, 2), mask)


@torch.no_grad()
def fit_batch_stats(tree, cfg, ref_u8, cur_u8, device):
    """Set ``tree``'s running statistics to what the batch normalisations
    see on these frames: each one's input mean and biased variance over the
    batch, the layers before it already normalised so (the feature encoder
    over both images, the context encoder over the first). A trained
    model's statistics keep its activations so scaled; with the identity,
    the drawn weights' biases would drown the frames' content."""
    model = RaftReference(tree, cfg, device)
    model.fitting = True
    with no_tf32():
        ref, cur = model.images(ref_u8, cur_u8)
        model.encoder(torch.cat([ref, cur]), "feature_enc")
        model.encoder(ref, "context_enc")
    tree["batch_stats"] = model.s
