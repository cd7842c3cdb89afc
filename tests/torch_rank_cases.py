"""Cases for spawned gloo ranks (``parallel/multihost_ba.py::spawn``) that
check the row-band collectives of ``parallel/height.py``. The ranks import
this module, so it imports no JAX."""

import numpy as np
import torch

from feature_tracker_tpu_torch.models.raft import Conv
from feature_tracker_tpu_torch.parallel.height import RowBands
from feature_tracker_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh

# name -> (kernel, stride) of a Conv from 3 to 4 channels
BAND_CONVS = {"3x3": (3, 1), "7x7": (7, 1), "5x1": ((5, 1), 1),
              "3x3 stride 2": (3, 2)}
CONV_INPUT = (2, 40, 12, 3)     # H = 40: bands of 24 + 16 rows


def band_conv(name):
    """The Conv of ``BAND_CONVS[name]`` with weights drawn from a seed."""
    kernel, stride = BAND_CONVS[name]
    conv = Conv(3, 4, kernel, stride)
    rng = np.random.default_rng(len(name))
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(rng.normal(
            0, 0.3, conv.weight.shape), dtype=torch.float32))
        conv.bias.copy_(torch.tensor(rng.normal(0, 0.1, 4),
                                     dtype=torch.float32))
    return conv


def conv_input():
    return torch.tensor(np.random.default_rng(3).normal(size=CONV_INPUT),
                        dtype=torch.float32)


def conv_bands_case(mesh) -> dict:
    """Each ``BAND_CONVS`` convolution of ``conv_input()`` computed on this
    rank's band of a ("data", "model") = (1, n) mesh: {name: the band's
    rows of the output}, and the band's first row."""
    mesh = make_mesh({"data": 1, "model": mesh.size()}, device="cpu")
    bands = RowBands(mesh, CONV_INPUT[1])
    x = bands.band(conv_input())
    with torch.no_grad():
        out = {name: band_conv(name)(x, bands) for name in BAND_CONVS}
    return {"start": bands.start, **out}


def collective_gradcheck_case(mesh, op: str, checked: int,
                              height: int = 16) -> bool:
    """``torch.autograd.gradcheck`` in float64 of ``RowBands.halo`` (k = 2,
    and k = 3 at 1/8 scale, which spans bands of one row) or
    ``RowBands.gather`` over a (1, n) mesh, through the scalar
    ``S = sum over ranks of <w_r, y_r>`` (``all_reduce_sum``), with rank
    ``checked``'s band as the variable. The other ranks feed their bands
    as constants (``0 * x`` keeps the graph and its collectives) and
    return ``0 * S``, so that only ``checked``'s seed and perturbations
    act: its gradient then crosses every transpose (the other ranks' halo
    and gather gradients summed back into its rows). Every rank runs
    gradcheck, so each makes the same collectives; the bands are equal
    in height for that."""
    mesh = make_mesh({"data": 1, "model": mesh.size()}, device="cpu")
    bands = RowBands(mesh, height)
    me = bands.index
    rng = np.random.default_rng(10 + me)
    band = torch.tensor(rng.normal(size=(2, bands.rows, 3, 2)))
    small = torch.tensor(rng.normal(size=(2, bands.rows // 8, 3, 2)))

    def outputs(x, y):
        if op == "halo":
            return [bands.halo(x, 2), bands.halo(y, 3)]
        return [bands.gather(x), bands.gather(y)]

    shapes = [t.shape for t in outputs(band, small)]
    weights = [torch.tensor(rng.normal(size=s)) for s in shapes]

    def f(x, y):
        if me != checked:
            x, y = band + 0 * x, small + 0 * y
        total = sum((w * t).sum() for w, t in zip(weights, outputs(x, y)))
        s = all_reduce_sum(mesh, total[None])
        return s if me == checked else 0 * s

    return torch.autograd.gradcheck(
        f, (band.clone().requires_grad_(), small.clone().requires_grad_()))
