"""K frame pairs tracked in one launch of the FAST KLT kernel, or in K.

The port of ``scripts/klt_multipair.py``.

The K pairs' pyramids are stacked vertically into one composite pyramid
per side, with a zero gap band after each pair, halved per level so that
each pair's row offset stays an integer at every level
(``trackers/klt/multi.py::build_composite_pyramids``); each pair's
features are offset into its band, and the whole-pyramid kernel
(``csrc/klt_fast.cu``) tracks all K*N features in one launch. The
sequential case makes K launches of N features each. Features stay 20 px
inside their crops, and the gap (128 rows at level 0) covers one extended
patch at the coarsest level, so no pixel of a neighbouring pair enters a
patch.

Each case is timed as a chain of ``inner`` calls (``_timing.py``; no
dispatch floor on the card, so ``floor_ms`` is 0) and reported per call.
Each pair's composite result, un-offset, is held to the sequential call
(on every feature, and on those at least ``parity_margin`` rows inside
their crop, which the composite tracks as the pair alone: nearer the
crop's top or bottom a coarse level's patch reads the zero gap) and to
the native CPU port (``runtime/cpu_baseline.py::klt_fast_cpu``);
when that library cannot be built the comparison is skipped and said so,
as in the JAX script.

The crops come from the reference's 752x480 optical-flow pair where
``FTK_DATA`` (as the demos read it) holds it, else from the synthetic pair
``tests/synthetic.py::translated_pair(h=480, w=752, shift=(7, -4))``.

    python -m feature_tracker_tpu_torch.scripts.klt_multipair \
        [K] [H] [W] [N_per_pair] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np
import torch

from feature_tracker_tpu_torch.core.config import KltOptions
from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.demos._common import DATA_ROOT
from feature_tracker_tpu_torch.ops.cuda_klt import track_pyramid_fast_cuda
from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
from feature_tracker_tpu_torch.runtime.cpu_baseline import klt_fast_cpu
from feature_tracker_tpu_torch.scripts._timing import (
    best_ms,
    device_fields,
    weights_unchanged,
)
from feature_tracker_tpu_torch.trackers.klt.multi import (
    build_composite_pyramids,
)

LEVELS, GAP, INNER = 4, 128, 8
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reference_pair():
    """``(ref, cur, source)``: the 752x480 gray pair of the reference's
    optical-flow example, or (``source`` "synthetic") the texture of
    ``tests/synthetic.py`` translated by (7, -4) px."""
    from feature_tracker_tpu_torch.utils.viz import load_gray_image

    paths = [os.path.join(DATA_ROOT, "optical_flow", f"{name}_image.png")
             for name in ("ref", "cur")]
    if all(os.path.exists(p) for p in paths):
        return (*(load_gray_image(p) for p in paths), "reference")
    # Loaded by path: the JAX script's ``from tests.synthetic import`` finds
    # whatever ``tests`` package the interpreter has installed first.
    spec = importlib.util.spec_from_file_location(
        "_ftk_synthetic", os.path.join(REPO_ROOT, "tests", "synthetic.py"))
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    ref, cur = synthetic.translated_pair(h=480, w=752, shift=(7.0, -4.0))
    return ref, cur, "synthetic"


def load_pairs(k, h, w, pair=None):
    """K ``(ref, cur)`` crops of ``h`` x ``w`` at origins drawn from
    ``default_rng(0)``, from ``pair`` (default :func:`reference_pair`)."""
    ref, cur = (pair or reference_pair())[:2]
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(k):
        r0 = int(rng.integers(0, ref.shape[0] - h + 1))
        c0 = int(rng.integers(0, ref.shape[1] - w + 1))
        pairs.append((ref[r0:r0 + h, c0:c0 + w].copy(),
                      cur[r0:r0 + h, c0:c0 + w].copy()))
    return pairs


def features(k, h, w, n):
    """``[K, N, 2]`` float32 positions, uniform 20 px inside each crop,
    from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    return np.stack([rng.uniform(20, w - 20, (k, n)),
                     rng.uniform(20, h - 20, (k, n))],
                    -1).astype(np.float32)


def offset_rows(uv, band):
    """Each pair's positions moved into its band of the composite (``uv``
    ``[K, N, 2]``; ``band`` the rows a pair and its gap take at level
    0); with ``-band``, the composite's positions back in their pair."""
    out = uv.copy()
    out[..., 1] += band * np.arange(uv.shape[0], dtype=np.float32)[:, None]
    return out


def parity_margin(opts):
    """Rows a feature must lie inside its crop for the composite to track
    it exactly as the pair alone (``trackers/klt/multi.py``): nearer the
    crop's top or bottom, a coarse level's patch reaches into the zero gap
    where the pair alone has its border rule."""
    half = max(opts.patch_row_half_size, opts.patch_col_half_size)
    return (half + 2) << (LEVELS - 1)


def composite_problem(k, h, w, n, device="cuda"):
    """The experiment's inputs on ``device`` and its two calls:
    ``composite()`` (one launch for ``k * n`` features on the composite
    pyramids) and ``sequential()`` (``k`` launches of ``n``), each returning
    a list of ``(uv, status)``; also ``uv`` (numpy ``[K, N, 2]``), the
    per-pair pyramids, ``band``, ``opts`` and ``source``."""
    dev = resolve_device(device)
    if h % (1 << (LEVELS - 1)) or GAP % (1 << (LEVELS - 1)):
        raise ValueError(f"H ({h}) and the gap ({GAP}) must be divisible "
                         f"by 2^(levels-1) = {1 << (LEVELS - 1)}")
    ref, cur, source = reference_pair()
    pairs = load_pairs(k, h, w, (ref, cur))
    uv = features(k, h, w, n)
    opts = KltOptions(max_track_points=n)
    opts_big = KltOptions(max_track_points=k * n)
    ref_pyrs = [build_pyramid(r, LEVELS, device=dev) for r, _ in pairs]
    cur_pyrs = [build_pyramid(c, LEVELS, device=dev) for _, c in pairs]
    comp_ref, band = build_composite_pyramids(ref_pyrs, gap=GAP)
    comp_cur, _ = build_composite_pyramids(cur_pyrs, gap=GAP)
    uv_comp = torch.as_tensor(offset_rows(uv, band).reshape(k * n, 2),
                              device=dev)
    uv_dev = torch.as_tensor(uv, device=dev)
    skip = torch.zeros(n, dtype=torch.bool, device=dev)
    skip_big = torch.zeros(k * n, dtype=torch.bool, device=dev)

    def composite():
        return [track_pyramid_fast_cuda(opts_big, comp_ref, comp_cur,
                                        uv_comp, uv_comp, skip_big)]

    def sequential():
        return [track_pyramid_fast_cuda(opts, ref_pyrs[i], cur_pyrs[i],
                                        uv_dev[i], uv_dev[i], skip)
                for i in range(k)]

    return {"composite": composite, "sequential": sequential, "uv": uv,
            "ref_pyrs": ref_pyrs, "cur_pyrs": cur_pyrs, "band": band,
            "opts": opts, "source": source, "device": dev}


def run(k=2, h=320, w=512, n=5120, *, inner=INNER, iters=3, rounds=3,
        device="cuda"):
    """Track ``k`` crops of ``h`` x ``w`` with ``n`` features each, as one
    composite launch and as ``k`` launches; returns the JAX script's dict
    plus the launches per call of each case and the composite's agreement
    with the sequential calls."""
    p = composite_problem(k, h, w, n, device)
    composite, sequential, dev = p["composite"], p["sequential"], p["device"]
    uv, band, opts = p["uv"], p["band"], p["opts"]
    ref_pyrs, cur_pyrs, source = p["ref_pyrs"], p["cur_pyrs"], p["source"]

    def chained(fn):
        def chain():
            total = 0.0
            for _ in range(inner):
                for cuv, st in fn():
                    total = total + cuv.sum() + st.sum()
            return total
        return chain

    dt_comp = best_ms(chained(composite), dev, iters, rounds)[0] / inner
    dt_seq = best_ms(chained(sequential), dev, iters, rounds)[0] / inner

    launches = track_pyramid_fast_cuda.launches
    [(cuv_c, st_c)] = composite()
    comp_launches = track_pyramid_fast_cuda.launches - launches
    seq = sequential()
    seq_launches = track_pyramid_fast_cuda.launches - launches - comp_launches
    cuv_c = offset_rows(cuv_c.cpu().numpy().reshape(k, n, 2), -band)
    st_c = st_c.cpu().numpy().reshape(k, n)
    cuv_s = np.stack([cuv.cpu().numpy() for cuv, _ in seq])
    st_s = np.stack([st.cpu().numpy() for _, st in seq])
    margin = parity_margin(opts)
    interior = (uv[..., 1] >= margin) & (uv[..., 1] <= h - margin)
    both = (st_c == 1) & (st_s == 1) & interior
    tracked_c = int((st_c == 1).sum())

    mismatch, maxd, cpu_dt = -1, -1.0, -1.0
    rp_np = [[lvl.cpu().numpy() for lvl in pyr] for pyr in ref_pyrs]
    cp_np = [[lvl.cpu().numpy() for lvl in pyr] for pyr in cur_pyrs]
    try:
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            outs = [klt_fast_cpu(rp_np[i], cp_np[i], uv[i], opts=opts)
                    for i in range(k)]
            best = min(best, (time.perf_counter() - t0) * 1e3)
    except RuntimeError as e:       # the native library could not be built
        print(f"[multipair] CPU port unavailable: {e}", flush=True)
    else:
        mismatch, maxd, cpu_dt = 0, 0.0, best
        for i, (cpu_uv, cpu_st) in enumerate(outs):
            mismatch += int((cpu_st != st_c[i]).sum())
            common = (cpu_st == 1) & (st_c[i] == 1)
            if common.any():
                maxd = max(maxd, float(np.abs(cpu_uv[common]
                                              - cuv_c[i][common]).max()))

    total = k * n
    return {
        "k_pairs": k, "resolution": f"{w}x{h}", "n_per_pair": n,
        "tracked_composite": tracked_c,
        "status_mismatch_vs_cpu": mismatch,
        "max_pos_diff_vs_cpu_px": maxd,
        "composite_ms": dt_comp,
        "sequential_ms": dt_seq,
        "composite_feats_per_s": total / dt_comp * 1e3,
        "sequential_feats_per_s": total / dt_seq * 1e3,
        "launch_amortization": dt_seq / dt_comp,
        "cpu_ms": cpu_dt,
        "vs_cpu_composite": cpu_dt / dt_comp if cpu_dt > 0 else -1.0,
        "floor_ms": 0.0, "inner_chain": inner,
        "composite_launches": comp_launches,
        "sequential_launches": seq_launches,
        "status_mismatch_composite_vs_sequential": int((st_c != st_s).sum()),
        "interior_margin_px": margin,
        "status_mismatch_composite_vs_sequential_interior": int(
            (st_c != st_s)[interior].sum()),
        "max_pos_diff_composite_vs_sequential_interior_px": float(
            np.abs(cuv_c[both] - cuv_s[both]).max()) if both.any() else 0.0,
        "source": source, **device_fields(dev),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("K", 2), ("H", 320), ("W", 512),
                          ("N_per_pair", 5120)):
        parser.add_argument(name, type=int, nargs="?", default=default)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    with weights_unchanged():
        out = run(args.K, args.H, args.W, args.N_per_pair,
                  device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
