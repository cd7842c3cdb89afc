"""Device meshes over process ranks, their placements, and the layer's
collectives.

The JAX package lays devices out in a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. Here a mesh is a ``DeviceMesh`` over the ranks of
the default process group: one process per rank (``torchrun``, or the
spawn helper of ``parallel/multihost_ba.py``), each computing on its own
contiguous slice of the feature or landmark axis (or, for the RAFT
trainers, of the batch and the image rows: ``parallel/height.py``), with
every cross-rank step an explicit collective made through
:func:`_all_reduce`, :func:`_all_gather` or, over one axis and
differentiably, :func:`all_gather_axis`. They count their calls and bytes
per operation (:func:`comm_stats`), the way the kernels' wrappers count
their launches.

The layout convention is JAX's: the fast intra-host axis carries the data
axis; the slower inter-host axis (``dcn``) is the OUTER axis of the same
shard dimension (:func:`make_multihost_mesh`), so shards are host-major.
A collective over a mesh of several axes runs over one axis at a time,
innermost first: the inter-host step then moves each host's partial sum
once (see :func:`ba_comm_report`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from feature_tracker_tpu_torch.core.device import resolve_device

_COMM = {}   # operation -> {"calls": int, "bytes": int}


def _init_single_rank(dev: torch.device) -> None:
    """A one-rank default process group when none exists, so that a single
    process gets a mesh without a launcher: NCCL for ``cuda``, gloo for
    ``cpu``, over an in-process store (no TCP port)."""
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, and this torch build "
                               "has none")
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape: dict | None = None, devices=None,
              device="cuda") -> DeviceMesh:
    """Build a mesh from {axis_name: size}.

    ``devices`` are ranks of the default process group (all of them by
    default), laid out in increasing order. Default shape: all of them on
    one ``data`` axis. A -1 size is inferred from the rank count (at most
    one -1). ``device`` is the device type of every rank (``"cuda"`` by
    default; without a GPU this raises unless it is ``"cpu"``). Every rank
    of the default group calls this with the same arguments."""
    dev = resolve_device(device)
    _init_single_rank(dev)
    ranks = sorted(devices if devices is not None
                   else range(dist.get_world_size()))
    if not shape:
        shape = {"data": len(ranks)}
    names = tuple(shape.keys())
    sizes = list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(ranks) // known
    total = int(np.prod(sizes))
    if total > len(ranks):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {len(ranks)}")
    layout = torch.tensor(ranks[:total], dtype=torch.int).reshape(sizes)
    return DeviceMesh(dev.type, layout, mesh_dim_names=names)


def make_multihost_mesh(num_hosts: int, devices=None,
                        device="cuda") -> DeviceMesh:
    """("dcn", "ici") mesh: the slow inter-host axis OUTERMOST so that the
    landmark/feature shard axis groups ranks host-major. Each host's shard
    stays on its own interconnect and the only inter-host traffic is the
    all-reduce of the reduced camera system (see parallel/ba.py and
    :func:`ba_comm_report`). Under ``torchrun`` with one rank per card,
    ranks are host-major already."""
    _init_single_rank(resolve_device(device))
    n = len(devices) if devices is not None else dist.get_world_size()
    if n % num_hosts:
        raise ValueError(f"{n} devices not divisible by {num_hosts} hosts")
    return make_mesh({"dcn": num_hosts, "ici": -1}, devices, device)


def ba_comm_report(num_poses: int, num_landmarks: int, obs_per_landmark: int,
                   mesh: DeviceMesh) -> dict:
    """Per-GN-iteration communication vs compute estimate for the
    landmark-sharded Schur BA. The only cross-rank traffic is the
    all-reduce of the reduced camera system: (6P)^2 + 6P floats. Compute
    is dominated by per-landmark Schur elimination: ~O(o^2*36 + o*180)
    flops per landmark on the shard."""
    p, l, o = num_poses, num_landmarks, obs_per_landmark
    n_dev = mesh.size()
    psum_bytes = 4 * ((6 * p) ** 2 + 6 * p)
    flops_per_lm = 36 * o * o + 400 * o  # Schur outer blocks + jacobians
    shard_flops = (l + n_dev - 1) // n_dev * flops_per_lm
    # The inter-host all-reduce moves the payload across the host boundary
    # once per direction (ring over the dcn axis); the intra-host stage
    # runs at ~10x the bandwidth.
    dcn = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("dcn", 1)
    dcn_bytes = psum_bytes * max(dcn - 1, 0) * 2
    return {"psum_bytes": psum_bytes, "dcn_bytes_per_iter": dcn_bytes,
            "shard_flops_per_iter": shard_flops,
            "flops_per_dcn_byte": shard_flops / max(dcn_bytes, 1)}


def feature_sharding(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """Placements that shard the leading (feature/landmark) dimension over
    ``axis``; when the mesh has several axes they all shard the leading
    dim (rank-major)."""
    if mesh.ndim == 1 and mesh.mesh_dim_names != (axis,):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {axis!r}")
    return tuple(Shard(0) for _ in range(mesh.ndim))


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in range(mesh.ndim))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def comm_stats() -> dict:
    """Calls and bytes of every collective the layer issued since the last
    :func:`reset_comm_stats`, by operation: ``{"all_reduce": {"calls": ..,
    "bytes": ..}, "all_gather": {...}}``, and the operations named in
    :func:`all_gather_axis` calls (``halo``, ``row_gather`` and their
    ``_backward`` all-reduces). An all-reduce counts its payload, an
    all-gather its gathered output, per call (one call per mesh axis for
    the first two)."""
    return {op: dict(v) for op, v in _COMM.items()}


def reset_comm_stats() -> None:
    _COMM.clear()


def _count(op: str, tensor: torch.Tensor) -> None:
    rec = _COMM.setdefault(op, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += tensor.numel() * tensor.element_size()


def _all_reduce(mesh: DeviceMesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over every rank of the mesh, in place."""
    for dim in reversed(range(mesh.ndim)):
        dist.all_reduce(tensor, group=mesh.get_group(dim))
        _count("all_reduce", tensor)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(ctx.mesh, grad.clone()), None


def all_reduce_sum(mesh: DeviceMesh, tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over every rank of the mesh, as a new tensor
    that autograd differentiates: the gradient that reaches it is summed
    over the ranks too, so each rank's input gets the gradient of the sum
    of every rank's loss. Both directions go through :func:`_all_reduce`
    (counted by :func:`comm_stats`)."""
    return _AllReduceSum.apply(tensor, mesh)


def _all_gather(mesh: DeviceMesh, tensor: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``tensor`` along dim 0, rank-major in the
    mesh's flattened order."""
    for dim in reversed(range(mesh.ndim)):
        parts = [torch.empty_like(tensor) for _ in range(mesh.size(dim))]
        dist.all_gather(parts, tensor, group=mesh.get_group(dim))
        tensor = torch.cat(parts)
        _count("all_gather", tensor)
    return tensor


class _AxisAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, mesh, axis, op):
        ctx.mesh, ctx.axis, ctx.op = mesh, axis, op
        group = mesh.get_group(axis)
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, tensor, group=group)
        out = torch.stack(parts)
        _count(op, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.get_group(ctx.axis))
        _count(ctx.op + "_backward", grad)
        return grad[ctx.mesh.get_local_rank(ctx.axis)], None, None, None


def all_gather_axis(mesh: DeviceMesh, axis: str, tensor: torch.Tensor,
                    op: str) -> torch.Tensor:
    """Every rank's ``tensor`` over the mesh axis ``axis`` (the ranks that
    share this rank's other coordinates), stacked on a new first dimension
    in the axis' order, as a tensor that autograd differentiates. The
    backward is the transpose: the gradient of every rank's copy of a part
    is summed over the axis (one all-reduce) and its owner keeps it. Both
    directions are counted by :func:`comm_stats`, under ``op`` and
    ``op + "_backward"``; every rank of the axis passes the same shape."""
    return _AxisAllGather.apply(tensor, mesh, axis, op)


def _shard_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh's flattened (row-major) order."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))
