"""Launcher for the landmark-sharded Schur BA over several processes, and
the helper that spawns ranks on one machine.

One process per rank. On cards, one per card, under ``torchrun`` (which
sets the ranks and the rendezvous; NCCL between them):

    torchrun --nproc-per-node=N -m feature_tracker_tpu_torch.parallel.multihost_ba \\
        --landmarks 65536 --iters 10

On several hosts, torchrun's ``--nnodes`` and ``--rdzv-endpoint`` give the
layout; ranks are host-major, so the ("dcn", "ici") mesh puts each host's
landmark slices on its own interconnect and the only inter-host traffic
per GN iteration is the all-reduce of the [6P, 6P] reduced camera system
(``ba_comm_report``). The single-machine form spawns gloo processes on
the CPU, two ranks per simulated host:

    python -m feature_tracker_tpu_torch.parallel.multihost_ba --simulate-hosts 2

Rank 0 prints one JSON line: hosts, devices, mesh, landmarks, poses,
iters, rms_initial, rms_final, wall_s, comm.

``spawn`` runs a function of this package on N fresh processes joined by
gloo over a ``FileStore`` (no TCP port); gloo moves CPU and CUDA tensors
alike, so several ranks may share one card. Its children import only
this package.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.parallel.ba import (
    BaOptions,
    bundle_adjust,
    reprojection_rms,
)
from feature_tracker_tpu_torch.parallel.mesh import (
    ba_comm_report,
    comm_stats,
    make_mesh,
    make_multihost_mesh,
)
from feature_tracker_tpu_torch.parallel.scaling import _make_problem
from feature_tracker_tpu_torch.parallel.sharded import (
    _gather_features,
    shard_features,
)

RANKS_PER_SIMULATED_HOST = 2
_GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def _rank_main(rank, world_size, store_path, device, threads, fn, args,
               results):
    """One spawned rank: join the group, run ``fn(*args)``, report."""
    try:
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1)
                                             // world_size))
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size, timeout=_GROUP_TIMEOUT)
        results.put((rank, fn(*args), None))
    except Exception:   # reported to the parent, which raises it
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, store_dir: str, *args, device="cuda",
          timeout: float = 900.0, threads: int | None = None) -> list:
    """Run ``fn(*args)`` on ``world_size`` new processes (the ``spawn``
    start method), joined in one default process group: gloo over a
    ``FileStore`` in ``store_dir``, which must be fresh. With ``device``
    ``"cuda"`` (the default; without a GPU this raises unless it is
    ``"cpu"``) rank r works on card r % count. ``fn`` and ``args`` are
    pickled, so ``fn`` is a top-level function. Returns the ranks' return
    values in rank order; raises on the first rank that fails (and stops
    the others) or after ``timeout`` seconds. Each rank computes with
    ``threads`` intra-op threads (default: the machine's cores shared out
    over the ranks)."""
    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store_path, device, threads,
                               fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    values = {}
    deadline = time.monotonic() + timeout
    try:
        while len(values) < world_size:
            try:
                rank, value, error = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if lost:
                    raise RuntimeError(f"rank {lost[0]} exited with code "
                                       f"{procs[lost[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in {timeout} s")
                continue
            if error is not None:
                raise RuntimeError(f"rank {rank} failed:\n{error}")
            values[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [values[r] for r in range(world_size)]


def _numpy(x):
    """Tensors (also inside tuples, lists and dicts) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x


def run_cases(device, cases) -> list:
    """A rank's body for :func:`spawn`: ``make_mesh(device=device)`` over
    every rank, then ``fn(mesh, *args)`` for each ``(fn, args)`` of
    ``cases`` (``functools.partial(track_klt_sharded, tracker)`` puts a
    mesh second), results as numpy, in order."""
    mesh = make_mesh(device=device)
    return [_numpy(fn(mesh, *args)) for fn, args in cases]


def ba_case(mesh, problem, opts: BaOptions) -> dict:
    """``bundle_adjust`` of the whole ``problem`` (q, t, landmarks, obs
    pose, obs uv, obs mask, k4; numpy, the same on every rank) with its
    landmarks sharded over the mesh. Returns q, t, every landmark, the rms
    history and the all-reduce calls and bytes of the run."""
    q, t, lm, idx, uv, mask, k4 = problem
    _, lm_s, idx_s, uv_s, mask_s = shard_features(mesh, lm, idx, uv, mask)
    before = comm_stats().get("all_reduce", {"calls": 0, "bytes": 0})
    q, t, lm_s, rms = bundle_adjust(q, t, lm_s, idx_s, uv_s, mask_s, k4,
                                    opts, mesh)
    after = comm_stats()["all_reduce"]
    return {"q": q, "t": t, "landmarks": _gather_features(mesh, lm_s,
                                                          len(lm)),
            "rms": rms,
            "all_reduce_calls": after["calls"] - before["calls"],
            "all_reduce_bytes": after["bytes"] - before["bytes"]}


def _launch(num_hosts, landmarks, obs, poses, iters, device):
    """The launcher's body on every rank; rank 0 returns the report."""
    mesh = make_multihost_mesh(num_hosts, device=device)
    q, t, lm, idx, uv, mask, k4 = _make_problem(landmarks, obs, poses)
    _, lm_d, idx_d, uv_d, mask_d = shard_features(
        mesh, lm, idx.astype(np.int64), uv, mask)
    q, t, k4 = (torch.as_tensor(a, device=lm_d.device) for a in (q, t, k4))
    opts = BaOptions(max_iterations=iters, num_fixed_poses=2)
    t0 = time.perf_counter()
    new_q, new_t, new_lm, rms = bundle_adjust(q, t, lm_d, idx_d, uv_d,
                                              mask_d, k4, opts, mesh)
    rms = rms.cpu()               # waits for the device
    wall = time.perf_counter() - t0
    final = float(reprojection_rms(new_q, new_t, new_lm, idx_d, uv_d, mask_d,
                                   k4, mesh))
    if dist.get_rank() != 0:
        return None
    return {"hosts": num_hosts, "devices": dist.get_world_size(),
            "mesh": {n: int(s) for n, s in
                     zip(mesh.mesh_dim_names, mesh.shape)},
            "landmarks": landmarks, "poses": poses, "iters": iters,
            "rms_initial": round(float(rms[0]), 4),
            "rms_final": round(final, 6),
            "wall_s": round(wall, 3),
            "comm": ba_comm_report(poses, landmarks, obs, mesh)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--simulate-hosts", type=int, default=0,
                    help="single-machine form: spawn this many hosts of "
                         f"{RANKS_PER_SIMULATED_HOST} gloo ranks each on "
                         "the CPU instead of joining torchrun's group")
    ap.add_argument("--landmarks", type=int, default=65536)
    ap.add_argument("--obs", type=int, default=4)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    problem = (args.landmarks, args.obs, args.poses, args.iters)

    if args.simulate_hosts:
        with tempfile.TemporaryDirectory() as store_dir:
            report = spawn(_launch, RANKS_PER_SIMULATED_HOST
                           * args.simulate_hosts, store_dir,
                           args.simulate_hosts, *problem, "cpu",
                           device="cpu")[0]
    else:
        hosts = 1        # without torchrun: one rank, its own group
        if "LOCAL_RANK" in os.environ:   # torchrun: one card per rank
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl")
            hosts = (dist.get_world_size()
                     // int(os.environ["LOCAL_WORLD_SIZE"]))
        try:
            report = _launch(hosts, *problem, "cuda")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    if report is not None:
        print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
