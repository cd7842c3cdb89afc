"""Run one cell of ``BENCHMARK.json`` once and reduce it to the result line.

A cell names a configuration and a traffic mix. The harness loads, by name:

- ``configs/<config>.json`` (the configuration as run; ``BENCHMARK.json``'s
  ``file``) and ``configs/<config>.py``, whose ``Session`` builds the port's
  object and the inputs from the seed, drives the entry point one call at a
  time, installs the traced run's spans, and decides ``correct`` against the
  plain reference in ``reference/``;
- ``traffic/<traffic>.json``, read by ``frames.py``;
- ``metrics/<metric>.py`` for every metric the cell reports, each with
  ``read(record)`` returning a number or None (nothing to read).

One run: set-up (``setup_s``, from process start to the first timed call),
a closed-loop window of ``seconds`` (each call starts when the last result
is back), then the output check once the window has closed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "feature_tracker_tpu")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics resolved by name."""

    def __init__(self, spec, workload, bench_dir=BENCH_DIR, root=ROOT,
                 patch=None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                              self.config_entry["file"]))
        self.module = load_module(
            os.path.join(bench_dir, "configs", self.entry["config"] + ".py"),
            "bench_config_" + self.entry["config"].replace(".", "_"))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        # ``patch`` (tests only) replaces keys of the configuration and of
        # the traffic, so that a test runs a cell at a size the CPU holds.
        patch = patch or {}
        self.config.update(patch.get("config", {}))
        self.traffic.update(patch.get("traffic", {}))
        self.chips = int(self.entry["chips"])
        self.end_to_end = self._metrics(spec["end_to_end"])
        self.per_layer = self._metrics(spec["per_layer"])
        self.bench_dir = bench_dir

    def _metrics(self, entries):
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric_name):
        return load_module(
            os.path.join(self.bench_dir, "metrics", metric_name + ".py"),
            "bench_metric_" + metric_name.replace(".", "_"))


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``."""

    def __init__(self, size, rng):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            k = self.rng.randrange(self.seen)
            if k < self.size:
                self.items[k] = item


class Record:
    """What the metric readers read: the window's per-call latencies, the
    set-up time, the traced run's spans and device trace, and the
    configuration's session (its work arithmetic)."""

    def __init__(self, session, latencies, window_s, setup_s, tracer=None,
                 profile=None):
        self.session = session
        self.latencies = latencies          # seconds, one per call
        self.frames_per_call = session.frames_per_call
        self.window_s = window_s
        self.setup_s = setup_s
        self.tracer = tracer
        self.profile = profile

    @property
    def frames(self):
        return len(self.latencies) * self.frames_per_call

    def frame_latencies(self):
        """Every frame's latency: a call's pairs share the call's."""
        return np.repeat(np.asarray(self.latencies, np.float64),
                         self.frames_per_call)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, Flax's, Optax's or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def check_device(chips, device):
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: {torch.cuda.device_count()} CUDA "
                         f"devices, the cell needs {chips}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(session, seconds, tracer=None, trace_calls=0):
    """The closed loop: calls until ``seconds`` have passed since the first
    began. With a ``tracer``, torch.profiler records the first
    ``trace_calls`` calls (all of them if 0); as many calls after them run
    plain, for the untraced time of a call (``Profile.plain_call_s``); the
    tracer's spans time the rest (``spans.py``). The trace is reduced once
    the window has closed. Returns ``(latencies, window_s, profile)``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans

    latencies, prof = [], None
    if tracer is not None:
        acts = [ProfilerActivity.CPU]
        if session.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        window_span = record_function(spans.WINDOW_SPAN)
        window_span.__enter__()

    def close_trace():
        _sync(session.device)
        window_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)

    start = end = time.perf_counter()
    i, traced, plain_from, plain_s = 0, 0, None, None
    while end - start < seconds:
        if tracer is not None:
            tracer.call = i
        t0 = time.perf_counter()
        out = session.call(i)
        end = time.perf_counter()
        latencies.append(end - t0)
        session.keep(i, out)
        i += 1
        if prof is not None and not traced and i == trace_calls:
            close_trace()
            traced = plain_from = i
        elif plain_from is not None and i - plain_from == traced:
            plain_s = sum(latencies[plain_from:i]) / (i - plain_from)
            tracer.timing, plain_from = True, None
    if prof is None:
        return latencies, end - start, None
    if not traced:
        close_trace()
        traced = i
    if plain_from is not None and i > plain_from:
        plain_s = sum(latencies[plain_from:i]) / (i - plain_from)
    print(f"trace: {traced} calls profiled, {i - traced} after them, "
          f"{sum(1 for c, _ in tracer.spans.get(session.call_span, ()))} "
          "timed", file=sys.stderr)
    summary = spans.summarize(prof, tracer.names | {session.call_span},
                              session.call_span, traced)
    summary.plain_call_s = plain_s
    return latencies, end - start, summary


def run_cell(spec, workload, seed, seconds, trace, device="cuda",
             started=None, bench_dir=BENCH_DIR, root=ROOT, patch=None):
    """One run of a cell. Returns ``(result, checks)``: the result line's
    dict and the compared numbers ``[(name, value, limit), ...]``."""
    started = time.perf_counter() if started is None else started
    cell = Cell(spec, workload, bench_dir, root, patch)
    check_device(cell.chips, device)
    # The threads of the port's torch operations on the host (the
    # configuration file's ``host_threads``; PyTorch's default otherwise).
    if "host_threads" in cell.config:
        torch.set_num_threads(int(cell.config["host_threads"]))
    stages = [("imports", time.perf_counter())]
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        stages.append(("card", time.perf_counter()))
    session = cell.module.Session(cell.config, cell.traffic, int(seed),
                                  device)
    stages.append(("inputs and model", time.perf_counter()))
    session.warm_up()
    stages.append(("warm-up", time.perf_counter()))
    tracer = None
    if trace:
        from benchmark.spans import Tracer
        tracer = Tracer(device)
        session.install_spans(tracer)
    session.start_window()
    _sync(device)
    setup_s = time.perf_counter() - started
    print("setup: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (name, t), t_prev in zip(
            stages, [started] + [t for _, t in stages])), file=sys.stderr)
    latencies, window_s, profile = run_window(
        session, seconds, tracer, int(cell.traffic.get("trace_frames", 0)))
    _sync(device)
    cuda = session.device.type == "cuda"
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    session.finish()
    record = Record(session, latencies, window_s, setup_s, tracer, profile)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = session.verify()
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(session.device) if cuda
                         else "cpu"),
                "count": cell.chips, "memory_peak_bytes": memory_peak}
    if trace and profile is not None:
        dev_info["busy_s"] = profile.busy_s
        dev_info["window_s"] = profile.window_s
    result = {"correct": bool(correct), "attempted": record.frames,
              "failed": 0, "metrics": metrics, "device": dev_info}
    if trace and profile is not None:
        result["breakdown"] = profile.breakdown()
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result, checks


def main(argv=None, started=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              args.trace, "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
