"""Readings that the limits of ``correct`` are set from: for each seed, the
compared numbers of the port after a short window at the cell's own load,
and of the control (the plain reference one precision below the
configuration's, in the port's place) on the same inputs.

    python3 benchmark/calibrate.py --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... [--control-seeds 1 2 3]

One JSON line per seed. Not part of a benchmark run: the limits in
``configs/<config>.py`` and their readings in ``PERF.md`` come from it.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.Cell(spec, args.workload)
    harness.check_device(cell.chips, args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        session = cell.module.Session(cell.config, cell.traffic, seed,
                                      args.device)
        session.warm_up()
        session.start_window()
        latencies, window_s, _ = harness.run_window(session, args.seconds)
        session.finish()
        line = {"workload": args.workload, "seed": seed,
                "calls": len(latencies), "port": session.compare()}
        if seed in args.control_seeds:
            line["control"] = session.compare(control=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
