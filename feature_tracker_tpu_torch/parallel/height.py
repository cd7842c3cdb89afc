"""Image rows split into bands over a mesh's ``model`` axis: the layout
behind height sharding of the RAFT trainers.

The JAX trainers take a batch ``[B, H, W, C]`` as ``P("data", "model")``
and GSPMD partitions every convolution over H, inserting the halo
exchanges and the gathers the correlation needs. The JAX package has no
module for this; here each rank computes on its own band of rows and the
exchanges are written out:

 - :class:`RowBands` cuts H into whole 8-row units, spread over the
   ``model`` axis as evenly as possible with the first bands one unit
   larger (H = 40 over two ranks: 24 + 16 rows). Every band starts on a
   multiple of 8, so the encoders' three stride-2 stages keep their phase
   and each band has a whole number of rows at 1/2, 1/4 and 1/8 scale.
 - :meth:`RowBands.halo`: this band with ``k`` rows of the bands around it
   above and below, zeros beyond the image's top and bottom (what a
   convolution's ``k // 2`` padding reads there).
 - :meth:`RowBands.gather`: the rows of every band, in order.

Each is one all-gather over the ``model`` group and, backward, one
all-reduce (``parallel/mesh.py::all_gather_axis``), counted by
``comm_stats`` as ``halo`` / ``halo_backward`` and ``row_gather`` /
``row_gather_backward``. A rank that holds fewer than ``k`` rows at some
scale passes its rows on, so a halo may come from several bands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from feature_tracker_tpu_torch.parallel.mesh import all_gather_axis

UNIT = 8        # rows: the feature maps' stride, 2 ** 3 stride-2 stages


def model_size(mesh) -> int:
    """The size of the mesh's ``model`` axis (1 without one)."""
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index("model")] if "model" in names else 1


def whole_count(mesh, bands, count: int, rows: int) -> int:
    """The element count over the whole batch of a tensor of which this
    rank of ``mesh`` holds ``count`` elements in ``rows`` image rows: its
    slice of the batch on every rank, or with ``bands`` its band of it."""
    return (count * mesh.size() if bands is None
            else bands.count(count, rows))


class RowBands:
    """This rank's band of the ``height`` rows of a batch on ``mesh`` (which
    has a ``model`` axis), and the collectives over that axis that compute
    on bands.

    ``starts`` and ``sizes`` hold every band's first row and row count at
    full resolution, in the axis' order; ``start`` and ``rows`` are this
    rank's. The methods take tensors ``[B, h, W, C]`` that are this rank's
    band at any of the model's scales; the scale is read from ``h``. A
    height that does not split into bands of whole 8-row units, at least
    one per rank of the ``model`` axis, raises a ``ValueError`` before any
    collective."""

    def __init__(self, mesh, height: int):
        self.mesh = mesh
        self.model = model_size(mesh)
        if height % UNIT or height // UNIT < self.model:
            raise ValueError(
                f"height sharding cuts H into {UNIT}-row units, at least one "
                f"per rank of the 'model' axis: H = {height} does not split "
                f"over {self.model} ranks (needs H % {UNIT} == 0 and H >= "
                f"{UNIT} * {self.model})")
        self.height = height
        self.data = mesh.size() // self.model
        self.index = mesh.get_local_rank("model")
        units, extra = divmod(height // UNIT, self.model)
        self.sizes = [UNIT * (units + (i < extra))
                      for i in range(self.model)]
        self.starts = [sum(self.sizes[:i]) for i in range(self.model)]
        self.start = self.starts[self.index]
        self.rows = self.sizes[self.index]

    def band(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` ``[B, H, ...]`` at full resolution."""
        return x[:, self.start:self.start + self.rows]

    def _scale(self, rows: int) -> int:
        scale = self.rows // rows
        if scale * rows != self.rows:
            raise ValueError(f"{rows} rows are not this rank's band of "
                             f"{self.rows} at any scale")
        return scale

    def offset(self, rows: int) -> int:
        """The first row of this band at the scale where it has ``rows``."""
        return self.start // self._scale(rows)

    def count(self, count: int, rows: int) -> int:
        """The element count over the whole batch of a tensor whose part
        on this rank holds ``count`` elements in ``rows`` rows of its
        band."""
        return count // rows * (self.height // self._scale(rows)) * self.data

    def halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """``x`` (this band) with the ``k`` rows above it and below it:
        ``[B, h + 2k, W, C]``."""
        b, h, w, c = x.shape
        scale = self._scale(h)
        starts = [s // scale for s in self.starts]
        ends = [s + n // scale for s, n in zip(starts, self.sizes)]
        fill = max(k - h, 0)
        # Each band's first k rows and last k rows; a band of fewer rows
        # sends all of them, padded past its end / before its start.
        edges = torch.stack([F.pad(x[:, :k], (0, 0, 0, 0, 0, fill)),
                             F.pad(x[:, -k:], (0, 0, 0, 0, fill, 0))])
        every = all_gather_axis(self.mesh, "model", edges, "halo")
        rows = every.permute(0, 1, 3, 2, 4, 5).reshape(-1, b, w, c)
        rows = torch.cat([rows, rows.new_zeros((1, b, w, c))])
        zero = len(rows) - 1
        index = []
        me = self.index
        for r in [*range(starts[me] - k, starts[me]),
                  *range(ends[me], ends[me] + k)]:
            if r < 0 or r >= ends[-1]:
                index.append(zero)
                continue
            j = max(i for i, s in enumerate(starts) if s <= r)
            if r < starts[me]:          # from j's last k rows
                index.append((2 * j + 1) * k + r - (ends[j] - k))
            else:                       # from j's first k rows
                index.append(2 * j * k + r - starts[j])
        picked = rows[index].permute(1, 0, 2, 3)
        return torch.cat([picked[:, :k], x, picked[:, k:]], dim=1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every band, ``[B, H / scale, W, C]``; each band is
        padded to the largest for the all-gather and cut back after."""
        scale = self._scale(x.shape[1])
        sizes = [n // scale for n in self.sizes]
        padded = F.pad(x, (0, 0, 0, 0, 0, max(sizes) - x.shape[1]))
        every = all_gather_axis(self.mesh, "model", padded, "row_gather")
        return torch.cat([every[j, :, :n] for j, n in enumerate(sizes)],
                         dim=1)
