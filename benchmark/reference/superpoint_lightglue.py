"""Plain float32 reference of SuperPoint + LightGlue inference, in plain torch.

SuperPoint (DeTone, Malisiewicz and Rabinovich, SuperPoint: Self-Supervised
Interest Point Detection and Description, CVPRW 2018, arXiv:1712.07629) and
LightGlue (Lindenberger, Sarlin and Pollefeys, LightGlue: Local Feature
Matching at Light Speed, ICCV 2023, arXiv:2306.13643), written out as
functions of the repository's weight files (``weights/superpoint.npz``,
``weights/lightglue_superpoint.npz``: the leaves ``a0 .. a{n-1}`` and the
tree's text under ``treedef``, read by :func:`load_variables`), or of the
same Flax-layout tree of numpy arrays. It shares no code with the port and
imports none of it. Every product runs in ``dtype`` (float32 with TF32 off,
:func:`no_tf32`; ``torch.bfloat16`` makes the control, the whole network in
bfloat16).

SuperPoint (:class:`SuperPointReference`): the VGG encoder 1-64-64 / 64-64
/ 64-128 / 128-128 of 3x3 convolutions, each followed by batch
normalisation on its running statistics (epsilon 1e-5) and ReLU, with a
2x2 max-pool after the second, fourth and sixth; the detector head (3x3 to
256, batch norm, ReLU, 1x1 to 65, softmax, the dustbin dropped, the 8x8
cells laid out as pixels) and the descriptor head (3x3 to 256, batch norm,
ReLU, 1x1 to 256). Keypoints (:func:`select_keypoints`): 3x3 maxima above
the threshold and at least 4 px from every edge, the 4096 best in
descending score (ties to the lower flat index), then the exact greedy
scan in that order: a candidate is kept unless a kept one lies at a squared
distance below ``radius^2``; the first ``max_num`` kept. Descriptors
(:func:`describe`): bilinear samples of the dense map at ``(uv + 0.5) / 8 -
0.5``, clamped to the map, L2-normalised.

LightGlue (:class:`LightGlueReference`): keypoints shifted and scaled into
~[-1, 1] by the bounding box of the valid ones; a 256 -> 256 input
projection; 9 layers, each a self-attention unit on either image (rotary
encoding by learned Fourier angles ``pos @ W``, rotating interleaved channel
pairs of queries and keys; 4 heads of 64) then a bidirectional
cross-attention unit (one projection for queries and keys, shared weights
both ways), each message fused as ``x + MLP([x | message])`` (Linear 512,
LayerNorm epsilon 1e-6, GELU tanh, Linear 256); masked keys take the logit
-1e9; the assignment is the dual-softmax of ``f0 f1^T / sqrt(256)`` (the
final projection's outputs) plus both log-sigmoid matchabilities, -1e9
where either point is masked. :func:`mutual_matches` is the release's
filter: each row's best column, kept where the column's best row points
back and the row's score reaches ``ln`` of the filter threshold.

Departures from the releases (cvg/LightGlue, magicleap's SuperPoint), each
listed under ``assumed`` in ``configs/superpoint_lightglue.json``: the
SuperPoint has batch normalisation; keypoints are 3x3 maxima with exact
greedy radius suppression, not the release's max-pool NMS; LightGlue keeps
its 256 -> 256 input projection where the release has none, uses GELU's
tanh form, gives its message MLP's LayerNorm an epsilon of 1e-6 (the
release's ``nn.LayerNorm`` takes torch's 1e-5), and normalises keypoints
by their bounding box (the matcher is given no image size); adaptive depth and width are off (the release with
``depth_confidence=-1, width_confidence=-1``); the weights are the
repository's own.
"""

from __future__ import annotations

import ast
import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
BORDER = 4
MAX_CANDIDATES = 4096


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and CUDA matrix products inside the
    block; the caller's settings are restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def load_variables(path):
    """The nested dict of numpy arrays a weight file holds: the treedef's
    text (nested dict literals, ``*`` for each leaf) with the i-th ``*``
    replaced by the array ``a{i}``."""
    with np.load(path) as data:
        text = bytes(data["treedef"]).decode()
        body = text[text.index("(") + 1:text.rindex(")")]
        pieces = body.split("*")
        literal = "".join(p + repr(f"a{i}") for i, p in
                          enumerate(pieces[:-1])) + pieces[-1]

        def fill(node):
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            return np.asarray(data[node])

        return fill(ast.literal_eval(literal))


def _tensors(tree, device, dtype):
    """The tree with each leaf a tensor of ``dtype`` on ``device``."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), dtype=dtype, device=device)


# -- SuperPoint ---------------------------------------------------------------

class SuperPointReference:
    """``forward(frame)``: a ``[H, W]`` gray frame (0..255, H and W
    multiples of 8) -> ``(heatmap [H, W], dense descriptors [H/8, W/8,
    256])``, both float32, computed in ``dtype``."""

    def __init__(self, variables, device, dtype=torch.float32):
        self.p = _tensors(variables["params"], device, dtype)
        self.s = _tensors(variables["batch_stats"], device, dtype)
        self.device, self.dtype = torch.device(device), dtype

    def _conv(self, x, i):
        w = self.p[f"Conv_{i}"]["kernel"].permute(3, 2, 0, 1)    # HWIO
        return F.conv2d(x, w, self.p[f"Conv_{i}"]["bias"],
                        padding=w.shape[-1] // 2)

    def _norm_relu(self, x, i):
        p, s = self.p[f"BatchNorm_{i}"], self.s[f"BatchNorm_{i}"]
        scale = p["scale"] / torch.sqrt(s["var"] + 1e-5)
        y = (x - s["mean"][:, None, None]) * scale[:, None, None]
        return torch.relu(y + p["bias"][:, None, None])

    def forward(self, frame):
        with no_tf32(), torch.no_grad():
            img = torch.as_tensor(frame, device=self.device)
            x = (img.to(torch.float32) / 255.0).to(self.dtype)[None, None]
            for i in range(8):
                x = self._norm_relu(self._conv(x, i), i)
                if i in (1, 3, 5):
                    x = F.max_pool2d(x, 2)
            det = self._conv(self._norm_relu(self._conv(x, 8), 8), 9)
            prob = torch.softmax(det[0], dim=0)[:64]          # [64, h, w]
            hc, wc = prob.shape[1:]
            heat = prob.reshape(8, 8, hc, wc).permute(2, 0, 3, 1).reshape(
                hc * 8, wc * 8)
            desc = self._conv(self._norm_relu(self._conv(x, 10), 9), 11)
            return heat.float(), desc[0].permute(1, 2, 0).float()


def select_keypoints(heat, max_num, min_response, radius):
    """Keypoints of a ``[H, W]`` heatmap on the host: ``(uv [max_num, 2]
    float32 numpy, (x, y), padded with -1; num)`` (see the module's
    docstring)."""
    h = np.asarray(torch.as_tensor(heat).float().cpu())
    rows, cols = h.shape
    pad = np.pad(h, 1, constant_values=-np.inf)
    local = np.max([pad[dy:dy + rows, dx:dx + cols]
                    for dy in range(3) for dx in range(3)], axis=0)
    cand = (h >= local) & (h > np.float32(min_response))
    cand[:BORDER] = cand[rows - BORDER:] = False
    cand[:, :BORDER] = cand[:, cols - BORDER:] = False
    flat = np.flatnonzero(cand)
    order = np.lexsort((flat, -h.reshape(-1)[flat]))[:MAX_CANDIDATES]
    # The squared distances below radius^2 (rounded to float32, as the
    # conflict test is made), as offsets around a candidate.
    limit = float(np.float32(float(radius) ** 2))
    reach = int(math.ceil(math.sqrt(limit)))
    dy, dx = np.mgrid[-reach:reach + 1, -reach:reach + 1]
    near = dy * dy + dx * dx < limit
    dy, dx = dy[near], dx[near]
    taken = np.zeros((rows + 2 * reach, cols + 2 * reach), bool)
    uv = np.full((max_num, 2), -1.0, np.float32)
    num = 0
    for f in flat[order]:
        if num == max_num:
            break
        y, x = divmod(int(f), cols)
        if not taken[y + reach + dy, x + reach + dx].any():
            taken[y + reach, x + reach] = True
            uv[num] = (x, y)
            num += 1
    return uv, num


def describe(desc_map, uv):
    """L2-normalised bilinear samples ``[K, D]`` of ``desc_map [h, w, D]``
    at the full-resolution positions ``uv [K, 2]``."""
    h, w, _ = desc_map.shape
    pos = (uv.float() + 0.5) / 8.0 - 0.5
    x = pos[:, 0].clamp(0.0, w - 1.0)
    y = pos[:, 1].clamp(0.0, h - 1.0)
    x0 = x.floor().long().clamp(0, w - 2)
    y0 = y.floor().long().clamp(0, h - 2)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    d = ((1 - fy) * ((1 - fx) * desc_map[y0, x0] + fx * desc_map[y0, x0 + 1])
         + fy * ((1 - fx) * desc_map[y0 + 1, x0]
                 + fx * desc_map[y0 + 1, x0 + 1]))
    return d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)


# -- LightGlue ----------------------------------------------------------------

class LightGlueReference:
    """``forward(kpts0, desc0, mask0, kpts1, desc1, mask1)`` -> ``(scores
    [N, M], logit0 [N], logit1 [M])``, float32, computed in ``dtype``:
    the log partial assignment (-1e9 where a point is masked) and the raw
    matchability logits."""

    def __init__(self, variables, device, dtype=torch.float32, heads=4):
        self.p = _tensors(variables["params"], device, dtype)
        self.depth = sum(1 for k in self.p if k.startswith("self_"))
        self.device, self.dtype = torch.device(device), dtype
        self.heads = heads

    def _linear(self, x, p):
        return x @ p["kernel"] + p["bias"]

    def _fuse(self, x, message, p):
        h = self._linear(torch.cat([x, message], -1), p["Dense_0"])
        ln = p["LayerNorm_0"]
        h = F.layer_norm(h, h.shape[-1:], ln["scale"], ln["bias"], 1e-6)
        return x + self._linear(F.gelu(h, approximate="tanh"), p["Dense_1"])

    def _split(self, x):
        return x.reshape(x.shape[0], self.heads, -1).transpose(0, 1)

    def _attend(self, q, k, v, key_mask):
        """Heads ``[H, N, d]`` of queries against ``[H, M, d]`` keys and
        values -> ``[N, H * d]``."""
        logits = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
        logits = logits.masked_fill(~key_mask, NEG_INF)
        out = torch.softmax(logits, -1) @ v
        return out.transpose(0, 1).reshape(q.shape[1], -1)

    def _rotate(self, x, cos, sin):
        """Interleaved channel pairs of ``x [H, N, d]`` turned by the
        per-point angles ``cos``, ``sin`` ``[N, d/2]``."""
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * cos - b * sin, a * sin + b * cos],
                           -1).flatten(-2)

    def _self(self, x, cos, sin, mask, p):
        q, k, v = (self._split(t) for t in
                   self._linear(x, p["qkv"]).reshape(x.shape[0], 3, -1)
                   .unbind(1))
        msg = self._attend(self._rotate(q, cos, sin),
                           self._rotate(k, cos, sin), v, mask)
        return self._fuse(x, self._linear(msg, p["out"]), p["MessageFuse_0"])

    def _cross(self, x0, x1, mask0, mask1, p):
        qk0, qk1 = (self._split(self._linear(x, p["qk"])) for x in (x0, x1))
        v0, v1 = (self._split(self._linear(x, p["v"])) for x in (x0, x1))
        m0 = self._linear(self._attend(qk0, qk1, v1, mask1), p["out"])
        m1 = self._linear(self._attend(qk1, qk0, v0, mask0), p["out"])
        return (self._fuse(x0, m0, p["MessageFuse_0"]),
                self._fuse(x1, m1, p["MessageFuse_0"]))

    @staticmethod
    def normalize(kpts, mask):
        """Keypoints into ~[-1, 1] by the bounding box of the valid ones
        (centre and half the larger side, at least 1; unchanged but for
        the centre (0.5, 0.5) when none is valid)."""
        if bool(mask.any()):
            valid = kpts[mask]
            hi, lo = valid.max(0).values, valid.min(0).values
        else:
            hi, lo = torch.ones(2, device=kpts.device), torch.zeros(
                2, device=kpts.device)
        half = torch.clamp((hi - lo).max() / 2.0, min=1.0)
        return (kpts - (hi + lo) / 2.0) / half

    def forward(self, kpts0, desc0, mask0, kpts1, desc1, mask1):
        with no_tf32(), torch.no_grad():
            def t(a, dtype=torch.float32):
                return torch.as_tensor(a, device=self.device).to(dtype)

            mask0, mask1 = t(mask0, torch.bool), t(mask1, torch.bool)
            angles = [(self.normalize(t(k), m).to(self.dtype)
                       @ self.p["FourierRotary_0"]["freq"]["kernel"])
                      for k, m in ((kpts0, mask0), (kpts1, mask1))]
            (c0, s0), (c1, s1) = ((torch.cos(a), torch.sin(a))
                                  for a in angles)
            x0 = self._linear(t(desc0, self.dtype), self.p["input_proj"])
            x1 = self._linear(t(desc1, self.dtype), self.p["input_proj"])
            for i in range(self.depth):
                x0 = self._self(x0, c0, s0, mask0, self.p[f"self_{i}"])
                x1 = self._self(x1, c1, s1, mask1, self.p[f"self_{i}"])
                x0, x1 = self._cross(x0, x1, mask0, mask1,
                                     self.p[f"cross_{i}"])
            f0 = self._linear(x0, self.p["final_proj"])
            f1 = self._linear(x1, self.p["final_proj"])
            sim = (f0 @ f1.T / math.sqrt(f0.shape[-1])).float()
            pair = mask0[:, None] & mask1[None, :]
            sim = sim.masked_fill(~pair, NEG_INF)
            logit0 = self._linear(x0, self.p["matchability"])[:, 0].float()
            logit1 = self._linear(x1, self.p["matchability"])[:, 0].float()
            z0 = F.logsigmoid(logit0).masked_fill(~mask0, NEG_INF)
            z1 = F.logsigmoid(logit1).masked_fill(~mask1, NEG_INF)
            scores = (torch.log_softmax(sim, 1) + torch.log_softmax(sim, 0)
                      + z0[:, None] + z1[None, :])
            return scores.masked_fill(~pair, NEG_INF), logit0, logit1


def mutual_matches(scores, filter_threshold):
    """``[N]`` int64 column of each row's mutual best match, -1 where there
    is none or its score is below ``ln(filter_threshold)``; the first of
    equal maxima."""
    best_col = scores.argmax(1)
    best_row = scores.argmax(0)
    rows = torch.arange(scores.shape[0], device=scores.device)
    ok = (best_row[best_col] == rows) & (
        scores.max(1).values >= math.log(filter_threshold))
    return torch.where(ok, best_col, torch.full_like(best_col, -1))
