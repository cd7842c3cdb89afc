"""Dense optical flow by Gunnar Farnebäck's polynomial expansion.

The JAX package's algorithm, step for step:
 - a normalised Gaussian kernel (sigma 1) and its moments k2 / k4 / k22;
 - per pixel the six Gaussian-weighted intensity moments S0, Sr, Sc, Src,
   Srr, Scc with a replicate border, as two separable passes;
 - per pixel an iterative solve: polynomial coefficients A, b from the
   moments, the current frame's coefficients bilinearly sampled at the
   warped position, the regularised step (M^T M + lambda I) d = M^T
   (b1 - b2) with M = A1 + A2 and lambda = 0.1 tr + 1, capped at
   ``max_delta_flow_step``;
 - a 3x3 median of both flow channels;
 - coarse to fine, the flow upsampled 2x with its magnitude doubled.

Flow is ``[2, H, W]``: channel 0 the row flow, 1 the column flow.

What parity with JAX needs here:
 - the moment passes are explicit float32 multiply-adds, so no convolution
   algorithm (nor TF32 on the card) changes their sums;
 - both frames' moments are rounded through bfloat16 and back, as JAX's
   gather table is (``.to(torch.bfloat16)`` rounds to nearest even, as XLA
   does), so identical images give exactly zero flow;
 - every division by a constant divides by a 0-dim tensor filled on the
   data's device (``_divisors``).
The flow is chaotic at the last bit (a ulp flips a bfloat16 rounding), so
the port agrees with JAX in distribution over pixels, not bit for bit.

JAX's all-done ``while_loop`` exit is a Python loop that reads
``done.all()`` once per iteration, one host synchronisation each;
``DenseOpticalFlow.last_stats`` records the iterations of the last call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from feature_tracker_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DenseFlowOptions:
    """Defaults of the reference's DenseOpticalFlow::Options."""

    max_iterations: int = 10
    half_patch_size: int = 2
    max_converge_step: float = 1e-6
    max_delta_flow_step: float = 1.0


def _kernel_moments(half: int):
    """The normalised Gaussian kernel's 1-D factor and its k2 / k4 / k22
    moments (numpy, float64)."""
    if half == 0:
        return np.ones(1), 0.0, 0.0, 0.0
    d = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-0.5 * d * d)  # sigma = 1
    w2d = np.outer(g, g)
    w2d /= w2d.sum()
    g1 = g / g.sum()  # separable factor of the normalised 2-D kernel
    dr = d[:, None]
    dc = d[None, :]
    k2 = float(np.sum(w2d * dr * dr))
    k4 = float(np.sum(w2d * dr ** 4))
    k22 = float(np.sum(w2d * dr * dr * dc * dc))
    return g1, k2, k4, k22


def _replicate(x, top, bottom, left, right):
    """Replicate-edge padding of the last two dimensions."""
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, *x.shape[-2:])
    out = F.pad(x4, (left, right, top, bottom), mode="replicate")
    return out.reshape(*lead, *out.shape[-2:])


def _moments(img, half: int, g1):
    """The 6 Gaussian-weighted moment maps ``[6, H, W]`` in the order
    (S0, Sr, Sc, Src, Srr, Scc).

    A rows pass gives the three distinct row-filtered planes (g, g*d,
    g*d*d); a columns pass maps them to the six moments. Each pass adds
    its k taps in order, as float32 multiply-adds of whole planes."""
    h, w = img.shape
    k = 2 * half + 1
    d = np.arange(-half, half + 1, dtype=np.float32)
    g = np.asarray(g1, np.float32)
    rows_k = torch.from_numpy(np.stack([g, g * d, g * d * d])).to(img.device)
    # Columns pass: the row plane and the column weights of each moment.
    #   S0=(g,g)p0  Sr=(gd,g)p1  Sc=(g,gd)p0  Src=(gd,gd)p1
    #   Srr=(gdd,g)p2  Scc=(g,gdd)p0
    planes = [0, 1, 0, 1, 2, 0]
    cols_k = torch.from_numpy(np.stack([g, g, g * d, g * d, g, g * d * d])).to(
        img.device)

    pad = _replicate(img, half, half, half, half)       # [H+2h, W+2h]
    r3 = rows_k[:, 0, None, None] * pad[None, 0:h]
    for i in range(1, k):
        r3 = r3 + rows_k[:, i, None, None] * pad[None, i:i + h]
    r6 = r3[planes]                                     # [6, H, W+2h]
    m6 = cols_k[:, 0, None, None] * r6[:, :, 0:w]
    for j in range(1, k):
        m6 = m6 + cols_k[:, j, None, None] * r6[:, :, j:j + w]
    return m6


def _divisors(k2, k4, k22, device):
    """The four constant divisors of the polynomial coefficients, as 0-dim
    float32 tensors filled on ``device``: a division by them is a true
    division on the card too (dividing by a Python float there multiplies by
    a rounded reciprocal), and filling them needs no copy from the host,
    which would wait for the device."""
    dd = k4 - k2 * k2
    ee = k22 - k2 * k2
    return tuple(torch.full((), c, device=device)
                 for c in (dd + ee + 1e-6, dd - ee + 1e-6, k22 + 1e-6,
                           k2 + 1e-6))


def _poly_coeffs(moments, k2, divisors):
    """Quadratic polynomial coefficients from moment maps.

    Returns (a, bq, c, br, bc): f ~ [r c] A [r c]^T + [br bc].[r c] + const
    with A = [[a, c/2], [c/2, bq]]."""
    s0, sr, sc, src, srr, scc = moments
    d_sum, d_diff, d_cross, d_lin = divisors
    term1 = (srr + scc - 2.0 * k2 * s0) / d_sum
    term2 = (srr - scc) / d_diff
    a = 0.5 * (term1 + term2)
    bq = 0.5 * (term1 - term2)
    c = src / d_cross
    br = sr / d_lin
    bc = sc / d_lin
    return a, bq, c, br, bc


def _interp_maps(maps, r, c):
    """Bilinear sample of ``maps [K, H, W]`` at the grids ``r``, ``c``
    with clamped taps; JAX's packed-table arithmetic, term for term. The
    four taps of every map come from one gather."""
    k, h, w = maps.shape
    r = r.clamp(0.0, h - 1.0)
    c = c.clamp(0.0, w - 1.0)
    r0 = torch.floor(r).to(torch.int64).clamp(0, h - 2)
    c0 = torch.floor(c).to(torch.int64).clamp(0, w - 2)
    fr = r - r0
    fc = c - c0
    gr = 1 - fr
    gc = 1 - fc
    two = torch.arange(2, device=maps.device)
    offs = (w * two[:, None] + two[None, :]).reshape(4, 1)  # 0, 1, w, w+1
    taps = maps.reshape(k, h * w)[:, (r0 * w + c0).reshape(1, -1) + offs]
    tl, tr, bl, br = (t.reshape(k, *r.shape) for t in taps.unbind(1))
    return gr * gc * tl + gr * fc * tr + fr * gc * bl + fr * fc * br


def _bf16_round(x):
    return x.to(torch.bfloat16).float()


def _track_single(opts: DenseFlowOptions, ref_img, cur_img, init_flow):
    """One level. Returns (flow [2, H, W], iterations)."""
    half = opts.half_patch_size
    g1, k2, k4, k22 = _kernel_moments(half)
    # Both frames' moments go through the same bfloat16 rounding (JAX
    # samples the current frame's from a bfloat16 table), so identical
    # images give b1 - b2 = 0 exactly.
    m_ref = _bf16_round(_moments(ref_img, half, g1))
    m_cur = _bf16_round(_moments(cur_img, half, g1))
    h, w = ref_img.shape
    dev = ref_img.device
    divisors = _divisors(k2, k4, k22, dev)
    a1, bq1, c1, br1, bc1 = _poly_coeffs(m_ref, k2, divisors)

    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    step_cap = torch.full((), opts.max_delta_flow_step, device=dev)

    flow = init_flow
    done = torch.zeros((h, w), dtype=torch.bool, device=dev)
    iterations = 0
    # Converged pixels stop updating, and once every pixel has converged
    # the remaining iterations are identity: the early exit is exact.
    while iterations < opts.max_iterations:
        m2 = _interp_maps(m_cur, rows + flow[0], cols + flow[1])
        a2, bq2, c2, br2, bc2 = _poly_coeffs(m2, k2, divisors)
        # M = A1 + A2, d = b1 - b2.
        m00 = a1 + a2
        m01 = 0.5 * (c1 + c2)
        m11 = bq1 + bq2
        d0 = br1 - br2
        d1 = bc1 - bc2
        # H = M^T M + lambda I, rhs = M^T d (M symmetric).
        h00 = m00 * m00 + m01 * m01
        h01 = m01 * (m00 + m11)
        h11 = m01 * m01 + m11 * m11
        lam = 0.1 * (h00 + h11) + 1.0
        h00 = h00 + lam
        h11 = h11 + lam
        g0 = m00 * d0 + m01 * d1
        g1_ = m01 * d0 + m11 * d1
        det = h00 * h11 - h01 * h01
        dr = (h11 * g0 - h01 * g1_) / det
        dc = (h00 * g1_ - h01 * g0) / det
        norm = torch.sqrt(dr * dr + dc * dc)
        cap = torch.minimum(step_cap / norm.clamp_min(1e-30),
                            torch.ones_like(norm))
        dr = dr * cap
        dc = dc * cap
        upd = ~done
        flow = flow + torch.stack([torch.where(upd, dr, 0.0),
                                   torch.where(upd, dc, 0.0)])
        done = done | (dr * dr + dc * dc < opts.max_converge_step)
        iterations += 1
        if bool(done.all()):            # one host synchronisation
            break
    return _median3x3(flow), iterations


def _median3x3(flow):
    """3x3 median of each flow channel with a replicate border."""
    pad = _replicate(flow, 1, 1, 1, 1)
    h, w = flow.shape[-2:]
    window = torch.stack([pad[:, i:i + h, j:j + w]
                          for i in range(3) for j in range(3)])
    return torch.sort(window, dim=0).values[4]


def _upsample_flow(flow, out_shape):
    """Bilinear 2x upsampling with the magnitude doubled:
    up[r, c] = interp(flow, r/2, c/2) * 2.

    The sample grid is regular (stride 1/2), so this is row and column
    interleaving without a gather: even outputs copy the source, odd ones
    average neighbours (0.5 (a + b) rounds as the two-weight sum does)."""
    h, w = out_shape
    k, sh, sw = flow.shape
    down = torch.cat([flow[:, 1:, :], flow[:, -1:, :]], dim=1)
    rows2 = torch.stack([flow, 0.5 * (flow + down)],
                        dim=2).reshape(k, 2 * sh, sw)
    right = torch.cat([rows2[:, :, 1:], rows2[:, :, -1:]], dim=2)
    full = torch.stack([rows2, 0.5 * (rows2 + right)],
                       dim=3).reshape(k, 2 * sh, 2 * sw)
    # Odd parent sizes sample at the clamped border: replicate the edge.
    if h > 2 * sh or w > 2 * sw:
        full = _replicate(full, 0, max(0, h - 2 * sh), 0, max(0, w - 2 * sw))
    return full[:, :h, :w] * 2.0


class DenseOpticalFlow:
    """Farnebäck dense flow tracker.

    ``track`` takes pyramids (sequences of ``[H, W]`` images, finest
    first) and returns the flow ``[2, H, W]`` (row flow, column flow) at
    full resolution, on the tracker's device. ``last_stats`` holds, after
    each call, the iterations run at each level (coarsest first) and the
    host synchronisations they took (one ``done.all()`` read each)."""

    def __init__(self, options: DenseFlowOptions | None = None,
                 device="cuda"):
        self.options = options or DenseFlowOptions()
        self.device = resolve_device(device)
        self.last_stats = {"iterations": [], "host_syncs": 0}

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _record(self, iterations):
        self.last_stats = {"iterations": iterations,
                           "host_syncs": sum(iterations)}

    def track_single_level(self, ref_img, cur_img, init_flow=None):
        ref_img = self._f32(ref_img)
        cur_img = self._f32(cur_img)
        if init_flow is None or np.shape(init_flow) != (2,) + ref_img.shape:
            init_flow = torch.zeros((2,) + ref_img.shape, device=self.device)
        flow, its = _track_single(self.options, ref_img, cur_img,
                                  self._f32(init_flow))
        self._record([its])
        return flow

    def track(self, ref_pyramid, cur_pyramid):
        levels = len(ref_pyramid)
        flow = torch.zeros((2,) + tuple(ref_pyramid[-1].shape),
                           device=self.device)
        iterations = []
        for lvl in range(levels - 1, -1, -1):
            flow, its = _track_single(self.options,
                                      self._f32(ref_pyramid[lvl]),
                                      self._f32(cur_pyramid[lvl]), flow)
            iterations.append(its)
            if lvl > 0:
                flow = _upsample_flow(flow, tuple(ref_pyramid[lvl - 1].shape))
        self._record(iterations)
        return flow
