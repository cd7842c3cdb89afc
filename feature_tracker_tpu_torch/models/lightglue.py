"""LightGlue attention matcher, for inference and its trainer — the counterpart
of ``feature_tracker_tpu/models/lightglue.py``.

Inputs: kpts_ref ``[N, 2]``, desc_ref ``[N, D]``, mask_ref ``[N]`` and the
same for the current image, plus an optional ``image_hw``.

 - input projection of descriptors to the model width d
 - ``depth`` layers; each runs a SELF-attention unit (rotary positional
   encoding from a learnable Fourier projection of the normalized keypoint
   positions, rotating interleaved channel pairs) then a CROSS-attention
   unit (one ``qk`` projection for queries and keys, no positional
   encoding), both applied to the two images with shared weights, the
   message fused via x + MLP([x | message])
 - assignment head: dual-softmax log partial assignment plus per-point
   log-matchability.

Masked keys get the logit ``NEG_INF`` (-1e9, not -inf), so a fully masked
row softmaxes to a uniform row, as in the JAX model; a boolean mask in
``scaled_dot_product_attention`` would give NaN there. Attention products
are computed in float32 whatever ``cfg.dtype`` is (JAX's
``preferred_element_type``).

Submodules carry the Flax model's names (``FourierRotary_0``,
``input_proj``, ``self_{i}``, ``cross_{i}``, ``final_proj``,
``matchability``), so a weight file's leaf path is its ``state_dict`` key
(``convert.py::lightglue_state_from_jax``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    divide,
    gelu,
)
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.utils.profiling import span

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    descriptor_dim: int = 256     # 256 for SuperPoint, 128 for DISK
    model_dim: int = 256
    num_heads: int = 4
    depth: int = 9
    dtype: torch.dtype = torch.float32


def normalize_keypoints(kpts, mask, image_hw=None):
    """Shift/scale keypoints into ~[-1, 1].

    With ``image_hw`` given, normalize by the image center and half max
    dim; otherwise by the bounding box of the valid keypoints."""
    if image_hw is not None:
        h, w = image_hw
        center = torch.stack([torch.full((), w / 2.0, dtype=kpts.dtype,
                                         device=kpts.device),
                              torch.full((), h / 2.0, dtype=kpts.dtype,
                                         device=kpts.device)])
        return divide(kpts - center[None, :], max(h, w) / 2.0)
    inf = torch.full_like(kpts, torch.inf)
    kmax = torch.where(mask[:, None], kpts, -inf).amax(dim=0)
    kmin = torch.where(mask[:, None], kpts, inf).amin(dim=0)
    ok = torch.isfinite(kmax).all() & torch.isfinite(kmin).all()
    kmax = torch.where(ok, kmax, torch.ones_like(kmax))
    kmin = torch.where(ok, kmin, torch.zeros_like(kmin))
    center = divide(kmax + kmin, 2.0)
    scale = torch.clamp(divide(torch.max(kmax - kmin), 2.0), min=1.0)
    return (kpts - center[None, :]) / scale


class FourierRotary(nn.Module):
    """Learnable Fourier features -> per-position rotation angles: 2D
    positions ``[N, 2]`` to (cos, sin), each ``[N, head_dim/2]``."""

    def __init__(self, head_dim: int, dtype=torch.float32):
        super().__init__()
        self.freq = Dense(2, head_dim // 2, bias=False, dtype=dtype)

    def forward(self, pos):
        angles = self.freq(pos)
        return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """Rotate channel pairs of ``x [N, H, Dh]`` by per-position angles
    ``cos/sin [N, Dh/2]``."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[:, None, :]
    s = sin[:, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape)


def _attend(q, k, v, key_mask):
    """Scaled dot-product attention over axis-0 tokens, in float32.

    q: [N, H, Dh], k/v: [M, H, Dh], key_mask: [M] bool."""
    dh = q.shape[-1]
    logits = torch.einsum("nhd,mhd->hnm", q.float(), k.float())
    logits = logits / torch.sqrt(torch.full((), float(dh),
                                            device=logits.device))
    logits = torch.where(key_mask[None, None, :], logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("hnm,mhd->nhd", attn, v.float())


class MessageFuse(nn.Module):
    """x + MLP([x | message]) with LayerNorm, as in the public LightGlue."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(2 * dim, 2 * dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(2 * dim)
        self.Dense_1 = Dense(2 * dim, dim, dtype=dtype)

    def forward(self, x, message):
        h = self.Dense_0(torch.cat([x, message], dim=-1))
        return x + self.Dense_1(gelu(self.LayerNorm_0(h)))


class SelfUnit(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)
        self.MessageFuse_0 = MessageFuse(dim, dtype)

    def forward(self, x, cos, sin, mask):
        dh = self.dim // self.heads
        n = x.shape[0]
        qkv = self.qkv(x).reshape(n, 3, self.heads, dh)
        q = apply_rotary(qkv[:, 0], cos, sin)
        k = apply_rotary(qkv[:, 1], cos, sin)
        msg = _attend(q, k, qkv[:, 2], mask).reshape(n, self.dim)
        return self.MessageFuse_0(x, self.out(msg))


class CrossUnit(nn.Module):
    """Bidirectional cross attention (shared weights for both directions)."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qk = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)
        self.MessageFuse_0 = MessageFuse(dim, dtype)

    def forward(self, x0, x1, mask0, mask1):
        def heads_of(a):
            return a.reshape(a.shape[0], self.heads, self.dim // self.heads)

        qk0, qk1 = heads_of(self.qk(x0)), heads_of(self.qk(x1))
        v0, v1 = heads_of(self.v(x0)), heads_of(self.v(x1))
        m0 = self.out(_attend(qk0, qk1, v1, mask1).reshape(x0.shape[0],
                                                           self.dim))
        m1 = self.out(_attend(qk1, qk0, v0, mask0).reshape(x1.shape[0],
                                                           self.dim))
        return self.MessageFuse_0(x0, m0), self.MessageFuse_0(x1, m1)


class LightGlue(nn.Module):
    """``forward(kpts_ref, desc_ref, mask_ref, kpts_cur, desc_cur, mask_cur,
    image_hw=None)`` returns the ``[N, M]`` log partial-assignment matrix
    (masked entries are NEG_INF) plus the per-side raw matchability logits
    ``[N]``, ``[M]``. Inputs may be numpy arrays or tensors; the model runs
    on ``device`` (default ``"cuda"``) in ``eval()`` mode, under
    ``torch.inference_mode`` unless ``grad=True`` (the trainer's form),
    and reads nothing back from the device. Spans ``lightglue.forward``
    (the call), ``lightglue.layer`` (each self- and cross-attention layer)
    and ``lightglue.assign`` (the assignment head)."""

    def __init__(self, cfg: LightGlueConfig = LightGlueConfig(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        c, dt = cfg, cfg.dtype
        self.FourierRotary_0 = FourierRotary(c.model_dim // c.num_heads, dt)
        self.input_proj = Dense(c.descriptor_dim, c.model_dim, dtype=dt)
        for i in range(c.depth):
            setattr(self, f"self_{i}", SelfUnit(c.model_dim, c.num_heads, dt))
            setattr(self, f"cross_{i}",
                    CrossUnit(c.model_dim, c.num_heads, dt))
        self.final_proj = Dense(c.model_dim, c.model_dim, dtype=dt)
        self.matchability = Dense(c.model_dim, 1, dtype=dt)
        self.to(self.device)
        self.eval()

    def forward(self, kpts_ref, desc_ref, mask_ref, kpts_cur, desc_cur,
                mask_cur, image_hw=None, *, grad: bool = False):
        with span("lightglue.forward"), torch.inference_mode(not grad), \
                full_float32():
            return self._forward(kpts_ref, desc_ref, mask_ref, kpts_cur,
                                 desc_cur, mask_cur, image_hw)

    def _forward(self, kpts_ref, desc_ref, mask_ref, kpts_cur, desc_cur,
                 mask_cur, image_hw):
        c = self.cfg

        def tensor(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        mask_ref, mask_cur = (tensor(m, torch.bool)
                              for m in (mask_ref, mask_cur))
        p0 = normalize_keypoints(tensor(kpts_ref), mask_ref, image_hw)
        p1 = normalize_keypoints(tensor(kpts_cur), mask_cur, image_hw)
        cos0, sin0 = self.FourierRotary_0(p0)
        cos1, sin1 = self.FourierRotary_0(p1)
        x0 = self.input_proj(tensor(desc_ref))
        x1 = self.input_proj(tensor(desc_cur))

        for i in range(c.depth):
            with span("lightglue.layer"):
                su = getattr(self, f"self_{i}")
                x0 = su(x0, cos0, sin0, mask_ref)
                x1 = su(x1, cos1, sin1, mask_cur)
                x0, x1 = getattr(self, f"cross_{i}")(x0, x1, mask_ref,
                                                     mask_cur)
        # Assignment head.
        with span("lightglue.assign"):
            f0 = self.final_proj(x0).float()
            f1 = self.final_proj(x1).float()
            pair = mask_ref[:, None] & mask_cur[None, :]
            sim = torch.einsum("nd,md->nm", f0, f1)
            sim = sim / torch.sqrt(torch.full((), float(c.model_dim),
                                              device=sim.device))
            sim = torch.where(pair, sim, NEG_INF)

            logit0 = self.matchability(x0)[:, 0]
            logit1 = self.matchability(x1)[:, 0]
            z0 = torch.where(mask_ref,
                             torch.nn.functional.logsigmoid(logit0), NEG_INF)
            z1 = torch.where(mask_cur,
                             torch.nn.functional.logsigmoid(logit1), NEG_INF)

            # Dual-softmax log partial assignment.
            lsm_row = torch.log_softmax(sim, dim=1)
            lsm_col = torch.log_softmax(sim, dim=0)
            scores = lsm_row + lsm_col + z0[:, None] + z1[None, :]
            scores = torch.where(pair, scores, NEG_INF)
            return scores, logit0, logit1


def mutual_argmax_matches(scores, min_score):
    """Per-row argmax, threshold on the row max, keep only if the column's
    argmax points back. Returns ``[N]`` int32 cur indices (-1 = unmatched).
    Ties resolve to the first index, as ``jnp.argmax`` and the reference's
    C++ scan with a strict ``>``."""
    row_best = torch.argmax(scores, dim=1).to(torch.int32)
    row_max = torch.amax(scores, dim=1)
    col_best = torch.argmax(scores, dim=0).to(torch.int32)
    rows = torch.arange(scores.shape[0], dtype=torch.int32,
                        device=scores.device)
    mutual = col_best[row_best.long()] == rows
    ok = (row_max >= min_score) & mutual
    return torch.where(ok, row_best, torch.full_like(row_best, -1))


def fused_match_list(scores, min_score, max_matches: int):
    """The "fused matches" output mode: ``[K, 2]`` int32 (ref, cur) index
    pairs sorted by score (a stable sort: equal scores keep the lower ref
    index first), padded with (-1, -1), plus the match scores
    (``K = min(max_matches, N)``)."""
    idx = mutual_argmax_matches(scores, min_score)
    n = scores.shape[0]
    safe = torch.clamp(idx, 0, scores.shape[1] - 1).long()
    sc = torch.take_along_dim(scores, safe[:, None], dim=1)[:, 0]
    sc = torch.where(idx >= 0, sc, torch.full_like(sc, -torch.inf))
    order = torch.argsort(-sc, stable=True)[:max_matches]
    sc_o = sc[order]
    ref_i = torch.where(sc_o > -torch.inf, order,
                        torch.full_like(order, -1)).to(torch.int32)
    cur_i = torch.where(ref_i >= 0, idx[torch.clamp(order, 0, n - 1)],
                        torch.full_like(ref_i, -1))
    pairs = torch.stack([ref_i, cur_i.to(torch.int32)], dim=-1)
    return pairs, torch.where(ref_i >= 0, sc_o, torch.zeros_like(sc_o))
