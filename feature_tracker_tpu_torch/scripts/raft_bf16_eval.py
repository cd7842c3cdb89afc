"""RAFT bfloat16 against float32: accuracy, speed and iteration split.

The port of ``scripts/raft_bf16_eval.py``.

Modes:
  accuracy       EPE of ``weights/raft_small.npz`` at float32 and bfloat16
                 compute on the 16 held-out 64x64 pairs of
                 ``weights/metrics.json``'s ``raft_small`` entry.
  anytime        that EPE at 6 and 12 iterations in float32, and the
                 zero-flow EPE.
  speed          the full configuration with ``low_memory`` at 1x440x1024:
                 float32, bfloat16 and bfloat16 with ``upsample_last_only``,
                 each at 1 and 12 iterations, giving
                   per iteration (lookup + update block + upsampling)
                     = (t12 - t1) / 11
                   encoders + correlation set-up ~= t1 - per iteration.
  split          the correlation lookup and the update block, each alone in
                 a loop of 12 iterations at 55x128 (440x1024 / 8) in the
                 shipped bfloat16 configuration, beside the whole call's
                 per-iteration time of ``speed``'s ``bf16_last_up``.
  speed_sidecar  the shipped configuration (bfloat16, ``upsample_last_only``)
                 at 12 and 6 iterations and the float32 one at 12, at
                 1x440x1024.

With ``low_memory`` every iteration launches the lookup kernel
(``ops/cuda_raft_lookup.py``, one launch per iteration on the card);
``accuracy`` and ``anytime`` take the all-pairs route and launch no kernel.
Timings follow ``_timing.py``. No mode writes under ``weights/``: the JAX
script's ``anytime`` and ``speed_sidecar`` rewrite
``weights/metrics.json``, these print their dict and, with ``--out PATH``,
also write it to PATH. Model weights for the timings are drawn from seed 0
as Flax's initializers draw them (the times depend on shapes, not values).

    python -m feature_tracker_tpu_torch.scripts.raft_bf16_eval MODE \
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os

import numpy as np
import torch

from feature_tracker_tpu_torch.core.device import resolve_device
from feature_tracker_tpu_torch.models.layers import flax_init_
from feature_tracker_tpu_torch.models.raft import (
    Raft,
    RaftConfig,
    UpdateBlock,
    full_float32,
    pool_feature_pyramid,
)
from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
    lookup_correlation_cuda,
)
from feature_tracker_tpu_torch.scripts._timing import (
    best_ms,
    device_fields,
    weights_unchanged,
)
from feature_tracker_tpu_torch.train.raft_eval import flow_metrics
from feature_tracker_tpu_torch.train.raft_pretrain import make_pool
from feature_tracker_tpu_torch.utils.weights import (
    WEIGHTS_DIR,
    load_raft_npz,
    weights_path,
)


def compact_cfg(dtype, iters=6):
    """The configuration of ``weights/raft_small.npz`` at compute ``dtype``
    (``torch.float32`` or ``torch.bfloat16``) and ``iters`` iterations."""
    return RaftConfig(max_iterations=iters, feature_channels=64,
                      context_channels=64, hidden_channels=32,
                      correlation_pyramid_levels=2, correlation_radius=3,
                      correlation_hidden_channels=32,
                      correlation_out_channels=16,
                      flow_hidden_channels=16, flow_out_channels=8,
                      motion_out_channels=16, mask_hidden_channels=32,
                      dtype=dtype)


def _compact_model(dtype, iters, dev):
    cfg = compact_cfg(dtype, iters)
    model = Raft(cfg, device=dev)
    model.load_state_dict(load_raft_npz(weights_path("raft_small.npz"), cfg))
    return model


def _held_out_pool(h, w, batch, n_batches, dev):
    # Seed 0 + 1000, as raft_pretrain.main draws its held-out pool.
    return make_pool(np.random.default_rng(1000), n_batches, h, w, batch,
                     augment=False, device=dev)


def accuracy(*, h=64, w=64, batch=4, n_batches=4, device="cuda"):
    """EPE and outlier fractions (``flow_metrics`` of the last prediction,
    averaged over the batches) of the shipped compact weights at float32
    and bfloat16 compute on the held-out pool, and their EPE difference."""
    dev = resolve_device(device)
    pool = _held_out_pool(h, w, batch, n_batches, dev)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = _compact_model(dtype, 6, dev)
        agg = None
        for ref, cur, gt in pool:
            preds = model(ref, cur)
            m = {k: float(v)
                 for k, v in flow_metrics(preds[-1].float(), gt).items()}
            agg = m if agg is None else {k: agg[k] + m[k] for k in m}
        out[name] = {k: round(v / len(pool), 4) for k, v in agg.items()}
    out["epe_delta_bf16_minus_f32"] = round(
        out["bf16"]["epe"] - out["f32"]["epe"], 4)
    return {f"raft_accuracy_{h}x{w}_compact_6it": out}


def anytime(*, h=64, w=64, batch=4, n_batches=4, device="cuda"):
    """Held-out EPE of the shipped compact weights (trained at 6
    iterations) at 6 and 12 iterations in float32, and the zero-flow
    EPE."""
    dev = resolve_device(device)
    pool = _held_out_pool(h, w, batch, n_batches, dev)
    out = {"resolution": f"{h}x{w}", "pairs": batch * n_batches,
           "weights": "raft_small.npz (trained at 6 iterations)"}
    for iters in (6, 12):
        model = _compact_model(torch.float32, iters, dev)
        agg = zf = 0.0
        for ref, cur, gt in pool:
            preds = model(ref, cur)
            agg += float(flow_metrics(preds[-1].float(), gt)["epe"])
            zf += float(flow_metrics(torch.zeros_like(gt), gt)["epe"])
        out[f"epe_k{iters}"] = round(agg / len(pool), 4)
        out["zero_flow_epe"] = round(zf / len(pool), 4)
    return {"raft_anytime": out}


def _images(h, w, dev):
    rng = np.random.default_rng(0)
    return tuple(torch.as_tensor(rng.uniform(0, 255, (1, h, w, 1)),
                                 dtype=torch.float32, device=dev)
                 for _ in range(2))


def _time_raft(cfg, ref, cur, iters, rounds):
    """``(ms per call, lookup-kernel launches per call)`` of a ``Raft(cfg)``
    call on ``ref`` / ``cur`` with seeded weights."""
    model = flax_init_(Raft(cfg, device=ref.device), 0)

    def run():
        return model(ref, cur)[-1].float().sum()

    before = lookup_correlation_cuda.launches
    ms, _ = best_ms(run, ref.device, iters, rounds)
    calls = 1 + iters * rounds
    return ms, (lookup_correlation_cuda.launches - before) / calls


def speed(*, h=440, w=1024, iterations=12, iters=3, rounds=3,
          device="cuda"):
    """ms per call at 1x``h``x``w`` of the full configuration with
    ``low_memory`` in float32, bfloat16 and bfloat16 with
    ``upsample_last_only``, at 1 and ``iterations`` iterations, and the
    per-iteration split those two times give. ``lookup_launches_per_call``
    counts the lookup kernel's launches (one per iteration on the card,
    none on the CPU)."""
    dev = resolve_device(device)
    ref, cur = _images(h, w, dev)
    k = iterations
    results = {}
    for name, dtype, last_only in (("f32", torch.float32, False),
                                   ("bf16", torch.bfloat16, False),
                                   ("bf16_last_up", torch.bfloat16, True)):
        times, launches = {}, {}
        for n_it in (1, k):
            cfg = RaftConfig(max_iterations=n_it, low_memory=True,
                             dtype=dtype, upsample_last_only=last_only)
            times[n_it], launches[f"{n_it}it"] = _time_raft(
                cfg, ref, cur, iters, rounds)
        per_it = (times[k] - times[1]) / (k - 1)
        results[name] = {
            f"ms_{k}it": round(times[k], 4),
            f"fps_{k}it": round(1e3 / times[k], 2),
            "per_iteration_ms": round(per_it, 4),
            "encoders_plus_init_ms": round(times[1] - per_it, 4),
            "lookup_launches_per_call": launches,
        }
    results["speedup_bf16"] = round(
        results["f32"][f"ms_{k}it"] / results["bf16"][f"ms_{k}it"], 3)
    results.update(device_fields(dev))
    return {f"raft_speed_{w}x{h}": results}


def split_inputs(h8, w8, cfg, device):
    """The loops' inputs at ``h8`` x ``w8``, drawn from ``default_rng(0)``
    in the JAX script's order: float32 ``fmap0``, the pooled pyramid of
    ``fmap1`` and the level-0 grid ``ref_locs`` for the lookup loop;
    ``net0``, ``inp``, ``corr0`` in ``cfg.dtype`` and a zero ``flow0`` for
    the update loop."""
    rng = np.random.default_rng(0)
    n_corr = cfg.correlation_pyramid_levels * (
        2 * cfg.correlation_radius + 1) ** 2

    def normal(channels, dtype):
        x = np.asarray(rng.normal(0, 1, (1, h8, w8, channels)), np.float32)
        return torch.as_tensor(x, device=device).to(dtype)

    fmap0 = normal(cfg.feature_channels, torch.float32)
    fmap1 = normal(cfg.feature_channels, torch.float32)
    fpyr = [f.contiguous() for f in pool_feature_pyramid(
        fmap1, cfg.correlation_pyramid_levels)]
    gx, gy = torch.meshgrid(
        torch.arange(w8, dtype=torch.float32, device=device),
        torch.arange(h8, dtype=torch.float32, device=device), indexing="xy")
    ref_locs = torch.stack([gx, gy], -1)[None].contiguous()
    return {"fmap0": fmap0, "fpyr": fpyr, "ref_locs": ref_locs,
            "net0": normal(cfg.hidden_channels, cfg.dtype),
            "inp": normal(cfg.context_channels, cfg.dtype),
            "corr0": normal(n_corr, cfg.dtype),
            "flow0": torch.zeros((1, h8, w8, 2), dtype=cfg.dtype,
                                 device=device)}


def lookup_loop(fmap0, fpyr, ref_locs, radius, iterations,
                lookup=lookup_correlation_cuda):
    """``iterations`` lookups, each from locations that depend on the last
    one's result (``locs + 1e-6 * mean(corr)``); returns the final
    locations (the loop's checksum is their sum). ``lookup`` is the
    kernel's wrapper (the plain ``lookup_correlation_otf`` for CPU
    tensors), or the plain version itself."""
    locs = ref_locs
    for _ in range(iterations):
        corr = lookup(fmap0, fpyr, locs, radius)
        locs = locs + 1e-6 * corr.mean()
    return locs


def update_loop(update, net0, inp, corr0, flow0, iterations):
    """``iterations`` steps of ``update`` (an ``UpdateBlock``) carrying
    ``(net, flow)``, with the correlation made to depend on the carry as
    the JAX loop does; returns the sum of the final flow and of every
    step's mask."""
    net, flow, masks = net0, flow0, 0.0
    with torch.inference_mode(), full_float32():
        for _ in range(iterations):
            corr = corr0 * (1.0 + 1e-20 * net.mean())
            net, up_mask, delta = update(net, inp, corr, flow)
            flow = flow + delta.to(flow.dtype)
            masks = masks + up_mask.float().sum()
        return flow.float().sum() + masks


def split(*, h=440, w=1024, iterations=12, iters=3, rounds=3,
          device="cuda"):
    """Per-iteration ms of the lookup and of the update block, each timed
    alone in a loop of ``iterations`` at ``h/8`` x ``w/8`` in the shipped
    bfloat16 configuration, against the whole call's per-iteration ms
    (``speed``'s ``bf16_last_up``: (t_iterations - t_1) / (iterations -
    1)) at ``h`` x ``w``, measured here too. ``*_checksum`` are the loops'
    results, ``lookup_launches_per_loop`` the kernel's launches in one
    lookup loop."""
    dev = resolve_device(device)
    cfg = RaftConfig(low_memory=True, dtype=torch.bfloat16,
                     upsample_last_only=True)
    h8, w8 = h // 8, w // 8
    x = split_inputs(h8, w8, cfg, dev)
    update = UpdateBlock(cfg).to(dev).to(memory_format=torch.channels_last)
    flax_init_(update.eval(), 0)

    def lookup_run():
        return lookup_loop(x["fmap0"], x["fpyr"], x["ref_locs"],
                           cfg.correlation_radius, iterations).sum()

    def update_run():
        return update_loop(update, x["net0"], x["inp"], x["corr0"],
                           x["flow0"], iterations)

    before = lookup_correlation_cuda.launches
    t_lookup, lookup_sum = best_ms(lookup_run, dev, iters, rounds)
    launches = (lookup_correlation_cuda.launches - before) / (
        1 + iters * rounds)
    t_update, update_sum = best_ms(update_run, dev, iters, rounds)

    ref, cur = _images(h, w, dev)
    whole = {n: _time_raft(dataclasses.replace(cfg, max_iterations=n), ref,
                           cur, iters, rounds)[0] for n in (1, iterations)}
    n_corr = cfg.correlation_pyramid_levels * (
        2 * cfg.correlation_radius + 1) ** 2
    return {"raft_iteration_split": {
        "resolution": f"{w}x{h} (/8: {w8}x{h8})", "iterations": iterations,
        "dtype": "bf16", "corr_channels": int(n_corr),
        "lookup_ms_per_iteration": round(t_lookup / iterations, 4),
        "update_block_ms_per_iteration": round(t_update / iterations, 4),
        "sum_ms_per_iteration": round((t_lookup + t_update) / iterations, 4),
        "whole_call_per_iteration_ms": round(
            (whole[iterations] - whole[1]) / (iterations - 1), 4),
        "lookup_checksum": lookup_sum, "update_checksum": update_sum,
        "lookup_launches_per_loop": launches, **device_fields(dev)}}


def speed_sidecar(*, h=440, w=1024, iterations=12, iters=2, rounds=2,
                  device="cuda"):
    """ms and frames/s of the shipped configuration (bfloat16,
    ``upsample_last_only``) at ``iterations`` and half as many, and of the
    float32 parity configuration at ``iterations``, at 1x``h``x``w``, with
    the lookup kernel's launches per call."""
    dev = resolve_device(device)
    ref, cur = _images(h, w, dev)
    out = {"resolution": f"{w}x{h}",
           "updated": datetime.datetime.now(
               datetime.timezone.utc).isoformat(timespec="seconds")}
    shipped = RaftConfig(low_memory=True, dtype=torch.bfloat16,
                         upsample_last_only=True)
    for key, cfg in (
            (f"shipped_k{iterations}", dataclasses.replace(
                shipped, max_iterations=iterations)),
            (f"shipped_k{iterations // 2}", dataclasses.replace(
                shipped, max_iterations=iterations // 2)),
            (f"parity_f32_k{iterations}", RaftConfig(
                max_iterations=iterations, low_memory=True))):
        ms, launches = _time_raft(cfg, ref, cur, iters, rounds)
        out[key] = {"ms": round(ms, 4), "fps": round(1e3 / ms, 2),
                    "lookup_launches_per_call": launches}
    out.update(device_fields(dev))
    return {"raft_speed": out}


MODES = {"accuracy": accuracy, "speed": speed, "speed_sidecar": speed_sidecar,
         "split": split, "anytime": anytime}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=sorted(MODES))
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--out", default=None,
                        help="also write the printed dict there as JSON "
                             "(never under weights/)")
    args = parser.parse_args(argv)
    weights = os.path.realpath(WEIGHTS_DIR) + os.sep
    if args.out and os.path.realpath(args.out).startswith(weights):
        parser.error(f"--out {args.out}: this script writes nothing under "
                     "weights/")
    with weights_unchanged():
        result = MODES[args.mode](device=args.device)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return result


if __name__ == "__main__":
    main()
