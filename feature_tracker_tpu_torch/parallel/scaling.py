"""Measured (not just estimated) scaling of the landmark-sharded BA.

``ba_comm_report`` (mesh.py) gives the closed-form bytes/flops estimate;
this module MEASURES per-iteration times of the same ``ba_step`` on a
one-rank mesh against the full mesh (and, with at least four ranks, the
("dcn", "ici") layout), plus a landmark-local-only variant that stops
before the reduced camera system is formed and all-reduced: the gap
between the two isolates the reduction, the collective and the replicated
solve. The collective's payload is read from the layer's own counters
(``comm_stats``) over one step.

Times are CUDA events around the calls on the card, the host clock on the
CPU (whose calls return when done). Ranks that share a card or a host's
cores do not scale: the number to read from them is that the step stays
correct when the all-reduce is added; scaling across hosts is the
extrapolation of ``measure_overhead_vs_landmarks`` from one-rank timings.
In a world of several ranks every rank takes part, and the first rank of
the mesh returns the report (the others None).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.raft import full_float32
from feature_tracker_tpu_torch.parallel.ba import (
    BaOptions,
    _landmark_terms,
    ba_step,
)
from feature_tracker_tpu_torch.parallel.mesh import (
    ba_comm_report,
    comm_stats,
    make_mesh,
    make_multihost_mesh,
)
from feature_tracker_tpu_torch.parallel.sharded import shard_features


def _make_problem(num_landmarks: int, obs: int, num_poses: int, seed=7):
    rng = np.random.default_rng(seed)
    k4 = np.asarray([200.0, 200.0, 160.0, 120.0], np.float32)
    lm = np.stack([rng.uniform(-3, 3, num_landmarks),
                   rng.uniform(-2, 2, num_landmarks),
                   rng.uniform(8, 16, num_landmarks)], -1).astype(np.float32)
    t = np.stack([np.zeros(num_poses), np.zeros(num_poses),
                  -0.4 * np.arange(num_poses)], -1).astype(np.float32)
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (num_poses, 1))
    idx = np.stack([rng.choice(num_poses, obs, replace=False)
                    for _ in range(num_landmarks)]).astype(np.int32)
    p_c = lm[:, None, :] + t[idx]
    uv = np.stack([200.0 * p_c[..., 0] / p_c[..., 2] + 160.0,
                   200.0 * p_c[..., 1] / p_c[..., 2] + 120.0],
                  -1).astype(np.float32)
    t_noisy = t + np.array([0, 0, 0.05], np.float32)
    return q, t_noisy, lm, idx, uv, np.ones(idx.shape, bool), k4


def _local_only(q, t, lm, idx, uv, mask, k4):
    """Shard-local Schur work only (jacobians, landmark elimination, the
    Schur rows of every observation), reduced to a scalar checksum: the
    reduced camera system is not formed, and nothing is communicated."""
    with full_float32():
        _, _, w, w_ainv, b_blk, rhs = _landmark_terms(
            q, t, lm, idx, uv, mask, k4, BaOptions(), lm)
        return w.sum() + w_ainv.sum() + b_blk.sum() + rhs.sum()


def _time_call(fn, args, iters: int, rounds: int = 3) -> float:
    """Best over ``rounds`` of the mean seconds per call of ``iters``
    back-to-back calls, after one untimed call."""
    cuda = args[0].is_cuda
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            sec = time.perf_counter() - t0
        best = min(best, sec / iters)
    return best


def _put(mesh, prob):
    """The problem on this rank: landmark axis sliced, poses replicated."""
    q, t, lm, idx, uv, mask, k4 = prob
    dev = torch.device(mesh.device_type)
    _, lm, idx, uv, mask = shard_features(mesh, lm, idx.astype(np.int64),
                                          uv, mask)
    rep = [torch.as_tensor(a, device=dev) for a in (q, t, k4)]
    return rep[0], rep[1], lm, idx, uv, mask, rep[2]


def _in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _step_on(mesh, opts):
    return lambda *a: ba_step(*a, opts, mesh=mesh)


def _ranks(devices):
    return list(devices) if devices is not None else list(
        range(dist.get_world_size()))


def measure_overhead_vs_landmarks(devices=None,
                                  l_list=(8192, 65536, 262144),
                                  obs: int = 4, num_poses: int = 8,
                                  iters: int = 3,
                                  dcn_gbps: float = 25.0,
                                  dcn_latency_ms: float = 0.5,
                                  device="cuda"):
    """The 2-host scaling case, extrapolated from one-rank timings.

    What is communicated per GN iteration is the all-reduce of the reduced
    camera system ([6P, 6P] + [6P], independent of L); every L-dependent
    stage (jacobians, Schur elimination, the per-shard partial sums,
    back-substitution) is landmark-local. Three measurements:

    1. The collective payload, counted by the layer's collective helper
       over one sharded step on the full mesh (``hlo_allreduce_bytes``,
       the name the JAX package's HLO count has), is compared with
       ``ba_comm_report``'s closed form.
    2. The L-independent serial part (replicated solve + update) is
       measured directly as the full step at tiny L.
    3. 2-host efficiency is extrapolated from ONE-rank timings:
         T_1host = step(L)
         T_2host = (step(L) - serial) / 2 + serial + dcn
         eff     = T_1host / (2 * T_2host),
       dcn = payload/dcn_gbps + latency (ring over 2 hosts: the payload
       crosses the host boundary once per direction).

    ``devices`` are ranks (all of the default group's by default) and
    ``device`` their device type."""
    dev = resolve_device(device)
    mesh_full = make_mesh(devices=devices, device=dev.type)
    mesh1 = make_mesh(devices=_ranks(devices)[:1], device=dev.type)
    n_dev = mesh_full.size()
    opts = BaOptions(max_iterations=1, num_fixed_poses=2)
    step_1, step_f = _step_on(mesh1, opts), _step_on(mesh_full, opts)

    analytic = ba_comm_report(num_poses, l_list[0], obs,
                              make_multihost_mesh(2, devices, dev.type)
                              if n_dev >= 4 and n_dev % 2 == 0
                              else mesh_full)
    before = comm_stats().get("all_reduce", {"bytes": 0})["bytes"]
    step_f(*_put(mesh_full, _make_problem(min(l_list), obs, num_poses)))
    counted = comm_stats()["all_reduce"]["bytes"] - before
    dcn_ms = (analytic["psum_bytes"] * 2 / (dcn_gbps * 1e6)
              + dcn_latency_ms)
    lead = _in_mesh(mesh1)

    # The L-independent serial part: the full step at tiny L (64
    # landmarks of local work are noise next to the [6P,6P] solve).
    if lead:
        serial_ms = _time_call(
            step_1, _put(mesh1, _make_problem(64, obs, num_poses)),
            10) * 1e3

    sweep = []
    for num_landmarks in l_list:
        prob = _make_problem(num_landmarks, obs, num_poses)
        it = max(1, min(iters, 262144 // num_landmarks + 1))
        full_ms = _time_call(step_f, _put(mesh_full, prob), it) * 1e3
        if not lead:
            continue
        one_ms = _time_call(step_1, _put(mesh1, prob), it) * 1e3
        parallel_ms = max(one_ms - serial_ms, 0.0)
        t2 = parallel_ms / 2.0 + serial_ms + dcn_ms
        sweep.append({
            "L": num_landmarks,
            "step_ms_1dev": round(one_ms, 3),
            "step_ms_full_mesh": round(full_ms, 3),
            "parallel_ms": round(parallel_ms, 3),
            "serial_plus_dcn_frac": round((serial_ms + dcn_ms) / one_ms, 4),
            "extrapolated_2host_efficiency": round(one_ms / (2.0 * t2), 4)})
    if not lead:
        return None
    return {"obs": obs, "num_poses": num_poses, "n_devices": n_dev,
            "dcn_gbps_assumed": dcn_gbps,
            "dcn_latency_ms_assumed": dcn_latency_ms,
            "analytic_psum_bytes": analytic["psum_bytes"],
            "hlo_allreduce_bytes": counted,
            "dcn_ms_modeled": round(dcn_ms, 4),
            "serial_ms_measured": round(serial_ms, 3),
            "sweep": sweep}


def measure_ba_scaling(devices=None, num_landmarks: int = 8192,
                       obs: int = 4, num_poses: int = 8,
                       iters: int = 5, device="cuda"):
    """Per-iteration ``ba_step`` time on one rank vs the full mesh vs the
    ("dcn","ici") layout, full step and local-only variant. Returns a dict
    with per-config ms and derived speedups/efficiencies plus the analytic
    ``ba_comm_report`` for comparison. ``devices`` are ranks (all of the
    default group's by default) and ``device`` their device type."""
    dev = resolve_device(device)
    mesh_full = make_mesh(devices=devices, device=dev.type)
    ranks = _ranks(devices)
    n_dev = len(ranks)
    configs = {"1dev": make_mesh(devices=ranks[:1], device=dev.type)}
    if n_dev > 1:
        configs[f"{n_dev}dev_flat"] = mesh_full
    if n_dev >= 4 and n_dev % 2 == 0:
        configs[f"{n_dev}dev_dcn2"] = make_multihost_mesh(2, ranks,
                                                          dev.type)
    prob = _make_problem(num_landmarks, obs, num_poses)
    opts = BaOptions(max_iterations=1, num_fixed_poses=2)

    out: dict = {"num_landmarks": num_landmarks, "obs": obs,
                 "num_poses": num_poses, "n_devices": n_dev,
                 "note": ("ranks that share a card or a host's cores do not "
                          "scale: the measured speedup is a lower bound; "
                          "see parallel/scaling.py")}
    for name, mesh in configs.items():
        if not _in_mesh(mesh):
            continue
        args = _put(mesh, prob)
        out[f"step_ms_{name}"] = round(
            _time_call(_step_on(mesh, opts), args, iters) * 1e3, 3)
        out[f"local_ms_{name}"] = round(
            _time_call(_local_only, args, iters) * 1e3, 3)
    if not _in_mesh(configs["1dev"]):
        return None
    if n_dev > 1:
        full = f"{n_dev}dev_flat"
        out["speedup_full_step"] = round(
            out["step_ms_1dev"] / out[f"step_ms_{full}"], 3)
        out["speedup_local_only"] = round(
            out["local_ms_1dev"] / out[f"local_ms_{full}"], 3)
        out["efficiency_full_step"] = round(
            out["speedup_full_step"] / n_dev, 3)
        out["efficiency_local_only"] = round(
            out["speedup_local_only"] / n_dev, 3)
        # Communication + reduction + replicated-solve overhead isolated
        # by the gap.
        out["comm_solve_overhead_ms"] = round(
            out[f"step_ms_{full}"] - out[f"local_ms_{full}"], 3)
        out["analytic"] = ba_comm_report(
            num_poses, num_landmarks, obs,
            configs.get(f"{n_dev}dev_dcn2", configs[full]))
    return out
