#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):
  1. The card (name and power limit from nvidia-smi) and the build of every
     kernel of the paths from the sources in this checkout, one nvcc per
     source, all started together.
  2. Each kernel against its plain PyTorch version on the card, at the
     headline shape (752x480, 4 levels, 10240 features, a pair translated
     by (7, -4)) and on border, off-image and skipped features: the FAST
     basic-KLT kernel (also at the front end's 300 features and with a
     31-row patch, wider than the TPU kernel's limit), the DIRECT / INVERSE
     basic-KLT kernel in both modes, the affine kernel through
     ``AffineKlt.track`` and the SE(2) kernel through ``LssdKlt.track`` with
     luminance off and on, the last two also on a pair rotated by 0.03 rad.
  3. The main paths through the front end, each with the launch counts set
     to 0 just before and read just after:
     ``TrackingFrontEnd(FrontEndConfig(), device="cuda")`` over a 752x480
     sequence translating a little each frame (24 frames, one FAST launch
     per tracked frame), and over 8 frames each with
     ``tracker=BasicKlt(method=INVERSE)`` (one launch per tracked frame),
     ``AffineKlt`` and ``LssdKlt`` (one launch per level and tracked
     frame): live tracks kept, the median tracked flow equal to the true
     shift, track ids kept across frames.
  4. Timings with CUDA events (warm-up first, median of >= 20 samples),
     each kernel's bound from its bytes and the operations of the steps
     actually taken, and torch.profiler windows over five headline kernel
     calls and ten more front-end frames.
Then one JSON line with the kernels of the paths, the card's name and power
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
WARP_FRAMES = 8                            # front-end frames per new tracker
# Affine / SE(2) kernels against their plain versions. Their 6x6 / 3x3
# systems hold absolute pixel coordinates and are ill-conditioned: with
# float32 sums the order of the patch sums alone showed through the solve
# (up to 0.08 px on a few lanes), which is why both sides accumulate the
# system in float64. The limits are what a float32 system could still meet.
WARP_UV_P99, WARP_UV_MAX = 1e-3, 5e-2      # px, commonly tracked features
AFFINE_P99, ROT_P99 = 5e-3, 1e-4           # matrix entries, 99th percentile
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


def status_agreement(label, ks, ps, limit):
    """Statuses of kernel and plain version as numpy; at most ``limit``
    may differ. Returns the mask of lanes both track."""
    n = len(ks)
    mismatch = int((ks != ps).sum())
    print(f"[compare] {label}: n={n} tracked kernel={int((ks == 1).sum())} "
          f"plain={int((ps == 1).sum())} status mismatches={mismatch} "
          f"(limit {limit})")
    check(mismatch <= limit, f"{label}: {mismatch} status mismatches of {n}")
    return (ks == 1) & (ps == 1)


def compare_klt(label, opts, rp, cp, uv, skip, status=None):
    """A basic-KLT kernel against its plain version on the same card
    inputs: the FAST kernel, or with ``status`` (the incoming statuses) the
    DIRECT / INVERSE kernel in ``opts.method``.
    Returns (max |duv| on commonly tracked features, plain GN steps)."""
    from feature_tracker_tpu_torch.ops import cuda_klt
    from feature_tracker_tpu_torch.trackers.klt import basic

    if status is None:
        wrapper, plain = (cuda_klt.track_pyramid_fast_cuda,
                          basic.track_pyramid_fast_reference)
        args = (opts, rp, cp, uv, uv, skip)
    else:
        wrapper, plain = (cuda_klt.track_pyramid_iter_cuda,
                          basic.track_pyramid_iter_reference)
        args = (opts, rp, cp, uv, uv, status, skip)
    before = wrapper.launches
    ku, ks = wrapper(*args)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1,
          f"{label}: the wrapper did not launch the kernel")
    pu, ps, steps = plain(*args, with_steps=True)
    ku, pu = ku.cpu().numpy(), pu.cpu().numpy()
    # Sums run in another order than in the plain version: at most 0.1 %
    # of statuses (at least 1) may flip at the convergence threshold.
    both = status_agreement(label, ks.cpu().numpy(), ps.cpu().numpy(),
                            max(1, len(ku) // 1000))
    err = float(np.abs(ku[both] - pu[both]).max()) if both.any() else 0.0
    print(f"[compare] {label}: max|duv| on both-tracked={err:.3g} px")
    sk = skip.cpu().numpy()
    check(np.array_equal(ku[sk], uv.cpu().numpy()[sk]),
          f"{label}: a skipped lane moved")
    check(np.isfinite(ku).all(), f"{label}: non-finite kernel uv")
    check(err <= UV_TOL, f"{label}: max |duv| {err} > {UV_TOL}")
    return err, steps


class LevelRecorder:
    """Stands in for a warp tracker's per-level function inside its level
    loop: runs the CUDA kernel or the plain version, and keeps each
    level's inputs, outputs and (plain) steps."""

    def __init__(self, kind, plain):
        self.kind, self.plain, self.levels = kind, plain, []

    def __call__(self, opts, *args):
        from feature_tracker_tpu_torch.ops import cuda_warp_klt as cw
        from feature_tracker_tpu_torch.trackers.klt import affine, lssd

        args = list(args)
        del args[-2]      # the incoming status: FAST mode rewrites it
        steps = None
        if self.plain:
            fn = (affine.affine_track_level_reference if self.kind == "affine"
                  else lssd.lssd_track_level_reference)
            *out, steps = fn(opts, *args, with_steps=True)
        else:
            fn = (cw.affine_track_level_cuda if self.kind == "affine"
                  else cw.lssd_track_level_cuda)
            out = fn(opts, *args)
        self.levels.append({"args": args, "out": out, "steps": steps})
        return tuple(out)


def p99_and_max(a, b, both):
    d = np.abs(a.cpu().numpy()[both] - b.cpu().numpy()[both])
    if d.size == 0:
        return 0.0, 0.0
    d = d.reshape(len(d), -1).max(axis=1)
    return float(np.percentile(d, 99)), float(d.max())


def compare_warp(label, tracker, rp, cp, uv, status=None):
    """A warp tracker's ``track`` on the card (every level through its CUDA
    kernel) against the same level loop through the plain versions.
    Returns (max |duv| on commonly tracked features, the kernel run's and
    the plain run's LevelRecorder, the tracker's uv and status)."""
    from feature_tracker_tpu_torch.ops import cuda_warp_klt as cw
    from feature_tracker_tpu_torch.trackers import klt

    kind = "affine" if isinstance(tracker, klt.AffineKlt) else "lssd"
    wrapper = (cw.affine_track_level_cuda if kind == "affine"
               else cw.lssd_track_level_cuda)
    levels = len(rp)
    before = wrapper.launches
    tu, tst = tracker.track(rp, cp, uv, None, status)
    torch.cuda.synchronize()
    check(wrapper.launches == before + levels,
          f"{label}: {wrapper.launches - before} launches for {levels} "
          "levels")
    ref_uv, cur_uv, st0 = tracker._prep(uv, None, status)

    def run(plain):
        rec = LevelRecorder(kind, plain)
        if kind == "affine":
            out = klt.affine_pyramid(tracker.options, rp, cp, ref_uv, cur_uv,
                                     st0, level_fn=rec)
        else:
            out = klt.lssd_pyramid(
                tracker.options, tracker.consider_patch_luminance, rp, cp,
                ref_uv, cur_uv, st0,
                tracker._f32(tracker.predict_rotation), level_fn=rec)
        return out, rec

    (ku, kst), krec = run(plain=False)
    (pu, pst), prec = run(plain=True)
    check(torch.equal(ku, tu) and torch.equal(kst, tst),
          f"{label}: track() and its level loop disagree")
    both = status_agreement(label, kst.cpu().numpy(), pst.cpu().numpy(),
                            max(1, len(ku) // 100))
    uv_p99, uv_max = p99_and_max(ku, pu, both)
    # The warp of the finest level: affine, or rotation.
    m_p99, m_max = p99_and_max(krec.levels[-1]["out"][1 if kind == "affine"
                                                      else 0],
                               prec.levels[-1]["out"][1 if kind == "affine"
                                                      else 0], both)
    m_name, m_lim = (("affine", AFFINE_P99) if kind == "affine"
                     else ("rotation", ROT_P99))
    print(f"[compare] {label}: |duv| p99={uv_p99:.3g} max={uv_max:.3g} px; "
          f"{m_name} entries p99={m_p99:.3g} max={m_max:.3g}")
    check(np.isfinite(ku.cpu().numpy()[both]).all(),
          f"{label}: non-finite kernel uv")
    check(uv_p99 <= WARP_UV_P99, f"{label}: p99 |duv| {uv_p99}")
    check(uv_max <= WARP_UV_MAX, f"{label}: max |duv| {uv_max}")
    check(m_p99 <= m_lim, f"{label}: p99 {m_name} difference {m_p99}")
    return uv_max, krec, prec, tu, tst


def klt_work(opts, pyr_shapes, n, n_tracked, steps, mode="fast"):
    """(bytes, FLOPs) the whole-pyramid basic KLT needs on these inputs:
    each pyramid level of both frames read once, uv/skip (and status) in
    and uv/status out once; per tracked feature and level the reference
    setup, and per Gauss-Newton step actually taken the resample, residual,
    products and solve. ``mode``: fast, inverse or direct; DIRECT resamples
    the extended patch every step, and both rebuild H every step."""
    pix = sum(h * w for h, w in pyr_shapes)
    nbytes = 2 * pix * 4 + n * (8 + 8 + 1) + n * (8 + 1)
    ex_n = opts.ex_patch_rows * opts.ex_patch_cols
    p_n = opts.patch_rows * opts.patch_cols
    if mode == "fast":
        setup = ex_n * 7 + p_n * 8 + 10    # bilinear taps; grads and H
        per_step = p_n * 12 + 14           # taps, dt, b; solve and update
    else:
        nbytes += n                        # the incoming status
        setup = ex_n * 7
        taps = p_n if mode == "inverse" else ex_n
        per_step = taps * 7 + p_n * 13 + 18  # taps; grads, dt, H, b; solve
    flops = n_tracked * len(pyr_shapes) * setup + int(steps) * per_step
    return nbytes, flops


def warp_level_work(kind, opts, img_shape, n, n_tracked, steps,
                    luminance=False):
    """(bytes, FLOPs) of one level of a warp tracker on these inputs: both
    images read once, the per-feature state in and out once; per tracked
    feature the reference setup (affine: and the 21 sums of H), per step
    actually taken the warp, a bilinear sample with its own weights (15),
    the residual, the system's sums and its solve (counted as ~2/3 n^3 +
    2 n^2 operations)."""
    h, w = img_shape
    ex_n = opts.ex_patch_rows * opts.ex_patch_cols
    p_n = opts.patch_rows * opts.patch_cols
    if kind == "affine":
        nbytes = 2 * h * w * 4 + n * (8 + 8 + 16 + 1) + n * (8 + 16 + 1)
        setup = ex_n * 7 + p_n * (2 + 2 + 4 + 42)
        per_step = p_n * (8 + 15 + 1 + 14) + 216 + 14
    else:
        nbytes = 2 * h * w * 4 + n * (8 + 16 + 8 + 1) + n * (16 + 8 + 1)
        setup = ex_n * 7 + p_n * (2 + (4 if luminance else 0))
        per_step = (p_n * (10 + 15 + 1 + 9 + 18 + (1 if luminance else 0))
                    + 36 + 25)
    return nbytes, n_tracked * setup + int(steps) * per_step


def bound(nbytes, flops):
    """(least ms the card could take, which resource bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def drive_front_end(label, fe, frames, wrapper, launches_per_frame,
                    min_live, true_flow):
    """Drive ``fe`` over ``frames`` with ``wrapper``'s launch count set to
    0 just before and read just after; check launches, live tracks, ids
    and the median tracked flow. Returns (launches, results, seconds per
    frame)."""
    from feature_tracker_tpu_torch.core.status import TrackStatus

    wrapper.launches = 0
    results, frame_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        results.append(fe.process_frame(f))   # ends in a device-to-host copy
        frame_s.append(time.perf_counter() - t0)
    launches = wrapper.launches
    tracked_frames = len(frames) - 1
    check(launches == tracked_frames * launches_per_frame,
          f"{label}: {launches} kernel launches over {tracked_frames} "
          f"tracked frames, expected {launches_per_frame} each")
    flows, kept = [], []
    for prev, res in zip(results, results[1:]):
        check(res.num_live >= min_live,
              f"{label} frame {res.frame_id}: {res.num_live} live tracks")
        check(np.isfinite(res.uv).all(), f"{label} frame {res.frame_id}: uv")
        # Lanes alive before and after whose id was not handed out this
        # frame are survivors: they must keep their id.
        old = (prev.track_ids >= 0) & (res.track_ids >= 0) & (
            res.track_ids <= prev.track_ids.max())
        check(np.array_equal(res.track_ids[old], prev.track_ids[old]),
              f"{label} frame {res.frame_id}: a surviving track changed "
              "its id")
        surv = old & (res.status == int(TrackStatus.TRACKED))
        kept.append(int(surv.sum()))
        flows.append(res.uv[surv] - prev.uv[surv])
    flow = np.median(np.concatenate(flows), axis=0)
    from_first = np.intersect1d(
        results[0].track_ids[results[0].track_ids >= 0],
        results[-1].track_ids)
    print(f"[front end] {label}: {len(frames)} frames 752x480: "
          f"launches={launches} "
          f"live min={min(r.num_live for r in results[1:])} survivors/frame "
          f"min={min(kept)} ids kept from frame 0={len(from_first)} "
          f"median flow=({flow[0]:.4f}, {flow[1]:.4f}) true={true_flow}")
    check(np.abs(flow - np.asarray(true_flow)).max() <= 0.05,
          f"{label}: median flow {flow} vs true {true_flow}")
    check(min(kept) >= min_live // 2,
          f"{label}: only {min(kept)} tracks survived a frame")
    return launches, results, frame_s


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
    from synthetic import Texture, se2_pair, translated_pair

    from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
    from feature_tracker_tpu_torch.ops import _build, cuda_klt, cuda_warp_klt
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.pipeline import (
        FrontEndConfig,
        TrackingFrontEnd,
    )
    from feature_tracker_tpu_torch.trackers.klt import (
        AffineKlt,
        BasicKlt,
        LssdKlt,
    )
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_level_reference,
    )
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_fast_reference,
        track_pyramid_iter_reference,
    )
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_level_reference,
    )

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions need full float32 matrix products")

    # 1. Build every kernel of the paths from this checkout's sources, one
    # nvcc per source, all started together.
    t0 = time.perf_counter()
    libraries = [cuda_klt.FAST_LIBRARY, cuda_klt.ITER_LIBRARY,
                 cuda_warp_klt.AFFINE_LIBRARY, cuda_warp_klt.LSSD_LIBRARY]
    lib_paths = _build.build_libraries(libraries)
    for load in (cuda_klt.load_klt_library, cuda_klt.load_klt_iter_library,
                 cuda_warp_klt.load_affine_library,
                 cuda_warp_klt.load_lssd_library):
        load()
    print(f"[build] {len(lib_paths)} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS[:3])}, in parallel)")
    for lib_path in lib_paths:
        print(f"[build] {os.path.relpath(lib_path, ROOT)}")
        if os.path.exists(lib_path + ".log"):
            with open(lib_path + ".log") as fh:
                for line in fh.read().splitlines():
                    if "ptxas info" in line and ("Used" in line
                                                 or "spill" in line):
                        print(f"[build]   {line.strip()}")

    # 2. Kernels against their plain versions. First the FAST kernel: at
    # the headline shape, at the front end's shape, and on two small cases.
    ref, cur = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    rp = build_pyramid(ref, LEVELS, device=dev)
    cp = build_pyramid(cur, LEVELS, device=dev)
    uv = torch.from_numpy(uniform_features(N, H, W, 20)).to(dev)
    no_skip = torch.zeros(N, dtype=torch.bool, device=dev)
    fresh = torch.zeros(N, dtype=torch.int8, device=dev)
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

    # The DIRECT / INVERSE kernel, both modes: headline and border case
    # (with incoming TRACKED and failed statuses; lane 5 skipped).
    bstatus = torch.zeros(len(buv), dtype=torch.int8, device=dev)
    bstatus[::3] = 1
    bstatus[5] = 4
    iter_errs, iter_steps, iter_opts = [], {}, {}
    for method in (KltMethod.INVERSE, KltMethod.DIRECT):
        mopts = KltOptions(max_track_points=N, method=method)
        iter_opts[method] = mopts
        e, iter_steps[method] = compare_klt(
            f"iter {method.value} headline 752x480 L=4 N=10240", mopts, rp,
            cp, uv, no_skip, fresh)
        iter_errs += [e, compare_klt(
            f"iter {method.value} border + off-image 96x64 L=2",
            KltOptions(method=method), brp, bcp, buv, bskip, bstatus)[0]]

    # The warp kernels through their trackers: translated pair, rotated
    # pair, and the border case with failed (skipped) lanes.
    sref, scur, s_rot, s_t = se2_pair(h=H, w=W, theta=0.03)
    srp = build_pyramid(sref, LEVELS, device=dev)
    scp = build_pyramid(scur, LEVELS, device=dev)
    true_uv = uv.cpu().numpy().astype(np.float64) @ s_rot.T + s_t
    warp_errs = {"affine": [], "lssd": []}
    warp_recs = {}
    trackers = {"affine": AffineKlt(opts), "lssd": LssdKlt(opts, False),
                "lssd luminance": LssdKlt(opts, True)}
    for tname, tracker in trackers.items():
        kind = tname.split()[0]
        e, krec, prec, _, _ = compare_warp(
            f"{tname} headline 752x480 L=4 N=10240", tracker, rp, cp, uv)
        warp_recs[tname] = (krec, prec)
        e2, _, _, su, sst = compare_warp(
            f"{tname} rotated 0.03 rad 752x480 L=4 N=10240", tracker, srp,
            scp, uv)
        ok = sst.cpu().numpy() == 1
        miss = np.linalg.norm(su.cpu().numpy()[ok] - true_uv[ok], axis=1)
        print(f"[compare] {tname} rotated pair: tracked {int(ok.sum())} of "
              f"{N}, median |uv - (R p + t)| = {np.median(miss):.4f} px")
        # (The luminance means only approximately cancel, which biases
        # that tracker by a fraction of a pixel in the JAX package too.)
        check(ok.sum() > N // 2 and (tname != "lssd"
                                     or np.median(miss) <= 0.1),
              f"{tname}: rotated pair not tracked ({int(ok.sum())} tracked, "
              f"median error {np.median(miss)})")
        small = type(tracker)(KltOptions(max_track_points=len(buv) - 1),
                              device=dev)
        if kind == "lssd":
            small.consider_patch_luminance = tracker.consider_patch_luminance
        e3, _, _, bu, bst = compare_warp(
            f"{tname} border + off-image 96x64 L=2", small, brp, bcp, buv,
            bstatus)
        bst = bst.cpu().numpy()
        check(bst[5] == 4 and torch.equal(bu[5], buv[5]),
              f"{tname}: the skipped lane did not pass through")
        check(list(bst[-3:-1]) == [3, 3] and bst[-1] == bstatus[-1].item(),
              f"{tname}: off-image / capped lanes gave {bst[-3:]}")
        warp_errs[kind] += [e, e2, e3]

    # 3. The main paths: the front end on the card. Fewer, shorter waves
    # than the default texture give the corner density of real imagery
    # (~100 Shi-Tomasi corners per 376x240 at the default thresholds).
    tex = Texture(0, n_waves=16, min_period=5.0, max_period=30.0)

    def render(t):
        return tex.render(H, W, warp=lambda x, y: (
            x - t * FRAME_SHIFT[0], y - t * FRAME_SHIFT[1]))

    frames = [render(t) for t in range(FRAMES)]
    fe = TrackingFrontEnd(cfg, device="cuda")
    launches, _, frame_s = drive_front_end(
        "basic FAST", fe, frames, cuda_klt.track_pyramid_fast_cuda, 1,
        cfg.min_live_tracks, FRAME_SHIFT)
    path_launches = {}
    for label, tracker, wrapper, per_frame in (
            ("basic INVERSE",
             BasicKlt(KltOptions(max_track_points=cfg.capacity,
                                 method=KltMethod.INVERSE)),
             cuda_klt.track_pyramid_iter_cuda, 1),
            ("affine", AffineKlt(cfg.klt),
             cuda_warp_klt.affine_track_level_cuda, cfg.pyramid_levels),
            ("lssd", LssdKlt(cfg.klt, False),
             cuda_warp_klt.lssd_track_level_cuda, cfg.pyramid_levels)):
        path_launches[label], _, path_s = drive_front_end(
            label, TrackingFrontEnd(cfg, tracker=tracker, device="cuda"),
            frames[:WARP_FRAMES], wrapper, per_frame, cfg.min_live_tracks,
            FRAME_SHIFT)
        print(f"[time] front end with {label} per tracked frame (host clock, "
              f"median of {len(path_s[2:])}): "
              f"{float(np.median(path_s[2:])) * 1e3:.4f} ms")

    # 4. Timings (the launches here are not the main paths').
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
    pyr_shapes = [tuple(l.shape) for l in rp]
    nbytes, flops = klt_work(opts, pyr_shapes, N, N, int(steps.sum()))
    bound_ms, bound_by = bound(nbytes, flops)
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
    kernels = [{
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
    }]

    # The DIRECT / INVERSE kernel: both modes are timed; the kernels line
    # carries INVERSE, the mode the front-end path above ran.
    for method in (KltMethod.INVERSE, KltMethod.DIRECT):
        mopts = iter_opts[method]
        m_ms = cuda_ms(lambda: cuda_klt.track_pyramid_iter_cuda(
            mopts, rp, cp, uv, uv, fresh, no_skip), batch=10)
        m_call = cuda_ms(lambda: cuda_klt.track_pyramid_iter_cuda(
            mopts, rp, cp, uv, uv, fresh, no_skip))
        m_plain = cuda_ms(lambda: track_pyramid_iter_reference(
            mopts, rp, cp, uv, uv, fresh, no_skip), repeats=20, warmup=2)
        m_steps = int(iter_steps[method].sum())
        m_bytes, m_flops = klt_work(mopts, pyr_shapes, N, N, m_steps,
                                    mode=method.value)
        m_bound, m_by = bound(m_bytes, m_flops)
        print(f"[time] klt iter kernel {method.value} 752x480 L=4 N=10240: "
              f"{m_ms:.4f} ms per launch back to back, {m_call:.4f} ms per "
              f"lone call; plain {m_plain:.4f} ms; bound {m_bound:.4f} ms by "
              f"{m_by} ({m_bytes} B, {m_flops} FLOP, {m_steps} GN steps)")
        if method == KltMethod.INVERSE:
            kernels.append({
                "name": "klt_iter_pyramid",
                "route": "cuda",
                "source": "feature_tracker_tpu_torch/csrc/klt_iter.cu",
                "replaces": "feature_tracker_tpu/ops/pallas_klt.py:1327",
                "launches": path_launches["basic INVERSE"],
                "max_abs_err": max(iter_errs),
                "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
                "bound_by": m_by, "library_ms": None,
            })

    # The warp kernels, one level per launch: each level's launch is timed
    # at the inputs the headline track() gave it; the kernels line carries
    # level 0 (752x480), the largest; the whole track() call is printed.
    for tname, tracker in trackers.items():
        kind = tname.split()[0]
        lum = kind == "lssd" and tracker.consider_patch_luminance
        krec, prec = warp_recs[tname]
        wrapper, plain_fn = (
            (cuda_warp_klt.affine_track_level_cuda,
             affine_track_level_reference) if kind == "affine" else
            (cuda_warp_klt.lssd_track_level_cuda, lssd_track_level_reference))
        rows = []
        for depth, (klvl, plvl) in enumerate(zip(krec.levels, prec.levels)):
            lvl = LEVELS - 1 - depth
            args = klvl["args"]
            l_ms = cuda_ms(lambda: wrapper(tracker.options, *args), batch=10)
            l_plain = cuda_ms(lambda: plain_fn(tracker.options, *args),
                              repeats=20, warmup=2)
            l_steps = int(plvl["steps"].sum())
            l_bytes, l_flops = warp_level_work(
                kind, tracker.options, pyr_shapes[lvl], N, N, l_steps, lum)
            l_bound, l_by = bound(l_bytes, l_flops)
            rows.append((l_ms, l_plain, l_bound, l_by))
            print(f"[time] {tname} kernel level {lvl} "
                  f"{pyr_shapes[lvl][1]}x{pyr_shapes[lvl][0]} N=10240: "
                  f"{l_ms:.4f} ms per launch back to back; plain "
                  f"{l_plain:.4f} ms; bound {l_bound:.4f} ms by {l_by} "
                  f"({l_bytes} B, {l_flops} FLOP, {l_steps} GN steps)")
        track_ms = cuda_ms(lambda: tracker.track(rp, cp, uv))
        print(f"[time] {tname} track() 752x480 L=4 N=10240 ({LEVELS} "
              f"launches and the level loop): {track_ms:.4f} ms per lone "
              f"call; kernels alone {sum(r[0] for r in rows):.4f} ms")
        if tname in ("affine", "lssd"):   # the front-end paths above
            l_ms, l_plain, l_bound, l_by = rows[-1]
            kernels.append({
                "name": f"klt_{kind}_level",
                "route": "cuda",
                "source": f"feature_tracker_tpu_torch/csrc/klt_{kind}.cu",
                "replaces": "feature_tracker_tpu/ops/pallas_warp_klt.py:"
                            + ("728" if kind == "affine" else "761"),
                "launches": path_launches[kind],
                "max_abs_err": max(warp_errs[kind]),
                "ms": l_ms, "plain_ms": l_plain, "bound_ms": l_bound,
                "bound_by": l_by, "library_ms": None,
            })
    print(f"[time] card: {card}")

    profile_window("klt kernel 752x480 L=4 N=10240",
                   lambda: cuda_klt.track_pyramid_fast_cuda(
                       opts, rp, cp, uv, uv, no_skip), calls=5)
    profile_window("lssd luminance track() 752x480 L=4 N=10240",
                   lambda: trackers["lssd luminance"].track(rp, cp, uv),
                   calls=5)
    more = iter([render(t) for t in range(FRAMES, FRAMES + 10)])
    profile_window("front end per frame",
                   lambda: fe.process_frame(next(more)), calls=10)

    check(len(kernels) == 4 and all(k["launches"] > 0 for k in kernels),
          "a kernel of the paths was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
