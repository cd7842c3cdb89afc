"""Inputs shared by the port's detection tests on the CPU
(``tests/test_torch_detect_suppress.py``) and on the card
(``tests/test_torch_cuda.py``). The module imports no JAX."""

import numpy as np


def tied_blobs():
    """``tests/test_torch_ops.py``'s tied image: an integer image of
    repeated identical blobs, so many corner responses tie exactly and the
    rank order of ties decides which candidates win."""
    img = np.zeros((96, 128), np.float32)
    for y in range(10, 90, 16):
        for x in range(10, 120, 16):
            img[y:y + 5, x:x + 5] = 200.0
    return img


def ring_points(centre):
    """``[20, 2]`` integer points (x, y): ``centre``, every integer point
    exactly 25 px from it (3-4-5 and 7-24-25 triangles), then three 24 px
    away. A strict distance test at 25 px keeps an exact-distance pair and
    suppresses a nearer one."""
    offsets = [(0, 0), (25, 0), (0, 25), (-25, 0), (0, -25)]
    for a, b in ((7, 24), (15, 20), (20, 15), (24, 7)):
        offsets += [(a, b), (-a, b), (a, -b), (-a, -b)]
    offsets += [(24, 0), (0, -24), (17, 17)]
    return np.array(centre) + np.array(offsets)
