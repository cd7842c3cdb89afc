#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):
  1. The card (name and power limit from nvidia-smi) and the build of every
     kernel of the path from the sources in this checkout.
  2. Each kernel against its plain PyTorch version on the card: the KLT
     kernel at the headline shape (752x480, 4 levels, 10240 features, a pair
     translated by (7, -4)) and at the front end's (300 features), on border
     and off-image features, and with a 31-row patch (wider than the TPU
     kernel's limit).
  3. The front end (``TrackingFrontEnd(FrontEndConfig(), device="cuda")``)
     over a 752x480 sequence translating a little each frame: one kernel
     launch per tracked frame, live tracks kept, the median tracked flow
     equal to the true shift, track ids kept across frames.
  4. Timings with CUDA events (warm-up first, median of >= 20 samples), and
     torch.profiler windows over five headline kernel calls and ten more
     front-end frames: device time by kernel and the device's idle share.
Then one JSON line per the kernels of the path, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA device, and outside a checkout of the
repository (the port and its kernel sources are imported from beside this
file).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

H, W, LEVELS, N = 480, 752, 4, 10240       # headline shape
PAIR_SHIFT = (7.0, -4.0)                   # (dx, dy) of the headline pair
FRAMES, FRAME_SHIFT = 24, (0.6, -0.35)     # front-end sequence, px / frame
REPEATS = 25                               # timed runs per median
UV_TOL = 1e-3                              # px, commonly tracked features
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = REPEATS, warmup: int = 3,
            batch: int = 1) -> float:
    """Median over ``repeats`` samples of the time per ``fn()`` call in ms,
    by CUDA events around ``batch`` back-to-back calls. With ``batch > 1``
    the host enqueues ahead of the device, so a kernel's time excludes the
    host's launch overhead; with ``batch == 1`` a call that is cheap on the
    device measures the host's enqueue time too."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def uniform_features(n, h, w, margin, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)],
                    -1).astype(np.float32)


def compare_klt(label, opts, rp, cp, uv, skip):
    """The KLT kernel against its plain version on the same card inputs.
    Returns (max |duv| on commonly tracked features, plain GN steps)."""
    from feature_tracker_tpu_torch.ops.cuda_klt import track_pyramid_fast_cuda
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_fast_reference,
    )

    before = track_pyramid_fast_cuda.launches
    ku, ks = track_pyramid_fast_cuda(opts, rp, cp, uv, uv, skip)
    torch.cuda.synchronize()
    check(track_pyramid_fast_cuda.launches == before + 1,
          f"{label}: the wrapper did not launch the kernel")
    pu, ps, steps = track_pyramid_fast_reference(opts, rp, cp, uv, uv, skip,
                                                 with_steps=True)
    ks, ps = ks.cpu().numpy(), ps.cpu().numpy()
    ku, pu = ku.cpu().numpy(), pu.cpu().numpy()
    n = len(ks)
    mismatch = int((ks != ps).sum())
    both = (ks == 1) & (ps == 1)
    err = float(np.abs(ku[both] - pu[both]).max()) if both.any() else 0.0
    print(f"[compare] {label}: n={n} tracked kernel={int((ks == 1).sum())} "
          f"plain={int((ps == 1).sum())} status mismatches={mismatch} "
          f"max|duv| on both-tracked={err:.3g} px")
    # Sums run in another order than in the plain version: at most 0.1 %
    # of statuses (at least 1) may flip at the convergence threshold.
    check(mismatch <= max(1, n // 1000),
          f"{label}: {mismatch} status mismatches of {n}")
    check(np.isfinite(ku).all(), f"{label}: non-finite kernel uv")
    check(err <= UV_TOL, f"{label}: max |duv| {err} > {UV_TOL}")
    return err, steps


def klt_work(opts, pyr_shapes, n, n_tracked, steps):
    """(bytes, FLOPs) the whole-pyramid KLT needs on these inputs: each
    pyramid level of both frames read once, uv/skip in and uv/status out
    once; per tracked feature and level the reference setup, and per
    Gauss-Newton step actually taken the resample, residual and products."""
    pix = sum(h * w for h, w in pyr_shapes)
    nbytes = 2 * pix * 4 + n * (8 + 8 + 1) + n * (8 + 1)
    ex_n = opts.ex_patch_rows * opts.ex_patch_cols
    p_n = opts.patch_rows * opts.patch_cols
    setup = ex_n * 7 + p_n * 8 + 10        # bilinear taps; grads and H
    per_step = p_n * 12 + 14               # taps, dt, b; solve and update
    flops = n_tracked * len(pyr_shapes) * setup + int(steps) * per_step
    return nbytes, flops


def profile_window(label: str, fn, calls: int) -> None:
    """Device time by kernel and the device's idle share over ``calls``
    calls of ``fn``, from torch.profiler (diagnostic: printed as not
    measured when the profiler reports no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev_rows)
    if busy_us == 0:
        print(f"[profile] {label}: device time not measured (the profiler "
              "reported none)")
        return
    print(f"[profile] {label}, {calls} calls: wall {wall_us / calls:.1f} "
          f"us/call, device busy {busy_us / calls:.1f} us/call, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / calls:9.1f} us/call"
              f" {e.count / calls:6.1f} launches/call  {e.key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from synthetic import Texture, translated_pair

    from feature_tracker_tpu_torch.core.config import KltOptions
    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.ops import _build, cuda_klt
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.pipeline import (
        FrontEndConfig,
        TrackingFrontEnd,
    )
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_fast_reference,
    )

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    # 1. Build every kernel of the path from this checkout's sources.
    t0 = time.perf_counter()
    lib_path = _build.library_path("ftk_klt_fast", cuda_klt._SOURCES)
    cuda_klt.load_klt_library()
    print(f"[build] {os.path.relpath(lib_path, ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS[:3])})")
    if os.path.exists(lib_path + ".log"):
        with open(lib_path + ".log") as fh:
            for line in fh.read().splitlines():
                if "ptxas info" in line and ("Used" in line
                                             or "spill" in line):
                    print(f"[build] {line.strip()}")

    # 2. Kernel against plain at the headline shape, at the front end's
    # shape, and on two small cases.
    ref, cur = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    rp = build_pyramid(ref, LEVELS, device=dev)
    cp = build_pyramid(cur, LEVELS, device=dev)
    uv = torch.from_numpy(uniform_features(N, H, W, 20)).to(dev)
    no_skip = torch.zeros(N, dtype=torch.bool, device=dev)
    opts = KltOptions(max_track_points=N)
    err, steps = compare_klt("headline 752x480 L=4 N=10240", opts, rp, cp,
                             uv, no_skip)
    cfg = FrontEndConfig()
    fe_uv = uv[:cfg.capacity].contiguous()
    fe_skip = no_skip[:cfg.capacity].contiguous()
    errs = [err, compare_klt(f"front end's shape N={cfg.capacity}", cfg.klt,
                             rp, cp, fe_uv, fe_skip)[0]]

    bref, bcur = translated_pair(h=64, w=96, shift=(1.0, 1.0))
    brp = build_pyramid(bref, 2, device=dev)
    bcp = build_pyramid(bcur, 2, device=dev)
    buv = np.concatenate([uniform_features(48, 64, 96, 1.0, seed=3),
                          [[-30.0, -30.0], [200.0, 20.0], [48.0, 32.0]]])
    buv = torch.from_numpy(buv.astype(np.float32)).to(dev)
    bskip = torch.zeros(len(buv), dtype=torch.bool, device=dev)
    bskip[5] = True
    errs.append(compare_klt("border + off-image 96x64 L=2", KltOptions(),
                            brp, bcp, buv, bskip)[0])
    wide = KltOptions(max_track_points=N, patch_row_half_size=15)
    errs.append(compare_klt("patch_row_half_size=15 (31x13 patch)", wide,
                            rp, cp, uv[:2048].contiguous(),
                            no_skip[:2048].contiguous())[0])

    # 3. The front end on the card: the main path. Fewer, shorter waves
    # than the default texture give the corner density of real imagery
    # (~100 Shi-Tomasi corners per 376x240 at the default thresholds).
    tex = Texture(0, n_waves=16, min_period=5.0, max_period=30.0)
    frames = [tex.render(H, W, warp=lambda x, y, t=t: (
        x - t * FRAME_SHIFT[0], y - t * FRAME_SHIFT[1]))
        for t in range(FRAMES)]
    fe = TrackingFrontEnd(cfg, device="cuda")
    cuda_klt.track_pyramid_fast_cuda.launches = 0
    results, frame_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        results.append(fe.process_frame(f))   # ends in a device-to-host copy
        frame_s.append(time.perf_counter() - t0)
    launches = cuda_klt.track_pyramid_fast_cuda.launches
    check(launches == FRAMES - 1,
          f"front end: {launches} kernel launches over {FRAMES - 1} "
          "tracked frames")
    flows, kept = [], []
    for prev, res in zip(results, results[1:]):
        check(res.num_live >= cfg.min_live_tracks,
              f"frame {res.frame_id}: {res.num_live} live tracks")
        check(np.isfinite(res.uv).all(), f"frame {res.frame_id}: uv")
        # Lanes alive before and after whose id was not handed out this
        # frame are survivors: they must keep their id.
        old = (prev.track_ids >= 0) & (res.track_ids >= 0) & (
            res.track_ids <= prev.track_ids.max())
        check(np.array_equal(res.track_ids[old], prev.track_ids[old]),
              f"frame {res.frame_id}: a surviving track changed its id")
        surv = old & (res.status == int(TrackStatus.TRACKED))
        kept.append(int(surv.sum()))
        flows.append(res.uv[surv] - prev.uv[surv])
    flow = np.median(np.concatenate(flows), axis=0)
    from_first = np.intersect1d(results[0].track_ids[results[0].track_ids
                                                     >= 0],
                                results[-1].track_ids)
    print(f"[front end] {FRAMES} frames 752x480: launches={launches} "
          f"live min={min(r.num_live for r in results[1:])} survivors/frame "
          f"min={min(kept)} ids kept from frame 0={len(from_first)} "
          f"median flow=({flow[0]:.4f}, {flow[1]:.4f}) true="
          f"{FRAME_SHIFT}")
    check(np.abs(flow - np.asarray(FRAME_SHIFT)).max() <= 0.05,
          f"front end: median flow {flow} vs true {FRAME_SHIFT}")
    check(min(kept) >= cfg.min_live_tracks // 2,
          f"front end: only {min(kept)} tracks survived a frame")

    # 4. Timings (the launches here are not the main path's).
    kernel_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        opts, rp, cp, uv, uv, no_skip), batch=10)
    call_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        opts, rp, cp, uv, uv, no_skip))
    plain_ms = cuda_ms(lambda: track_pyramid_fast_reference(
        opts, rp, cp, uv, uv, no_skip), repeats=20, warmup=2)
    ref_t = torch.from_numpy(ref).to(dev)
    pyr_ms = cuda_ms(lambda: build_pyramid(ref_t, LEVELS, device=dev))
    det_ms = cuda_ms(lambda: detect_good_features(ref_t, cfg.capacity,
                                                  cfg.harris, device=dev))
    fe_kernel_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        cfg.klt, rp, cp, fe_uv, fe_uv, fe_skip), batch=10)
    fe_call_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        cfg.klt, rp, cp, fe_uv, fe_uv, fe_skip))
    frame_ms = float(np.median(frame_s[2:])) * 1e3
    nbytes, flops = klt_work(opts, [tuple(l.shape) for l in rp], N, N,
                             int(steps.sum()))
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS
                else "operations")
    print(f"[time] klt kernel 752x480 L=4 N=10240: {kernel_ms:.4f} ms "
          f"per launch back to back ({N / kernel_ms * 1e3:.4g} features/s), "
          f"{call_ms:.4f} ms per lone call; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes} B, {flops} FLOP, {int(steps.sum())} GN "
          "steps)")
    print(f"[time] klt kernel at the front end's shape (N={cfg.capacity}): "
          f"{fe_kernel_ms:.4f} ms per launch back to back, "
          f"{fe_call_ms:.4f} ms per lone call")
    print(f"[time] klt plain PyTorch version on the card: {plain_ms:.4f} ms")
    print(f"[time] build_pyramid 752x480 L=4: {pyr_ms:.4f} ms")
    print(f"[time] detect_good_features 752x480 max_num=300: {det_ms:.4f} ms")
    print(f"[time] front end per tracked frame (host clock, median of "
          f"{len(frame_s[2:])}): {frame_ms:.4f} ms")
    print(f"[time] card: {card}")

    profile_window("klt kernel 752x480 L=4 N=10240",
                   lambda: cuda_klt.track_pyramid_fast_cuda(
                       opts, rp, cp, uv, uv, no_skip), calls=5)
    more = iter([tex.render(H, W, warp=lambda x, y, t=t: (
        x - t * FRAME_SHIFT[0], y - t * FRAME_SHIFT[1]))
        for t in range(FRAMES, FRAMES + 10)])
    profile_window("front end per frame",
                   lambda: fe.process_frame(next(more)), calls=10)

    print(json.dumps({"kernels": [{
        "name": "klt_fast_pyramid",
        "route": "cuda",
        "source": "feature_tracker_tpu_torch/csrc/klt_fast.cu",
        "replaces": "feature_tracker_tpu/ops/pallas_klt.py:1016",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
