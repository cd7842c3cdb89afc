"""Small batched linear systems for per-feature Gauss-Newton steps: the 2x2
in closed form, the symmetric 3x3 / 6x6 built and solved in float64.

A singular H yields non-finite steps and raises nothing; the iteration
scaffold turns a NaN step into NUMERIC_ERROR."""

from __future__ import annotations

import torch


def solve2x2(h00, h01, h11, b0, b1):
    """Closed-form solve of the symmetric 2x2 system H v = b.

    Batched over any leading shape; returns ``[..., 2]``. The expression
    order is that of the JAX package, so ``det`` and both numerators round
    the same way."""
    det = h00 * h11 - h01 * h01
    v0 = (h11 * b0 - h01 * b1) / det
    v1 = (h00 * b1 - h01 * b0) / det
    return torch.stack([v0, v1], dim=-1)


def gram(j: torch.Tensor) -> torch.Tensor:
    """``H = J^T J`` for float32 ``j [N, P, D]``, accumulated in float64
    (see :func:`normal_equations`)."""
    jd = j.double()
    return jd.transpose(1, 2) @ jd


def normal_equations(j: torch.Tensor, r: torch.Tensor):
    """``H = J^T J`` and ``b = -J^T r`` for float32 ``j [N, P, D]`` and
    ``r [N, P]``, accumulated in float64 (returned as float64).

    The warp trackers' systems hold absolute pixel coordinates and reach
    cond(H) ~ 1e8: in float32 the order of the sums alone moves the
    solution by up to a fraction of a pixel. The per-pixel terms stay
    float32; their products are exact in float64, so the sums are the same
    to 1e-16 in any order (and in the CUDA kernels)."""
    b = -(j.double().transpose(1, 2) @ r.double()[..., None])[..., 0]
    return gram(j), b


def solve_sym(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``H v = b`` for batches of small symmetric matrices
    (``h [..., D, D]``, ``b [..., D]``; D is 3 or 6) in float64 by LU with
    partial pivoting; returns float32.

    ``torch.linalg.solve`` raises when any element of the batch is
    singular; ``solve_ex`` does not, and leaves inf / NaN in that
    element's solution, which the iteration scaffold turns into
    NUMERIC_ERROR as the JAX package does."""
    if h.shape[0] == 0:
        return b.float()
    x, _ = torch.linalg.solve_ex(h.double(), b.double()[..., None],
                                 check_errors=False)
    return x[..., 0].float()
