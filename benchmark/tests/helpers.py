"""Small sizes at which a cell runs on the CPU in a test."""

import os

from benchmark import harness

SPEC_PATH = os.path.join(harness.ROOT, "BENCHMARK.json")

# Each configuration cut to a size the CPU holds in a test; the traffic keeps
# its motion and shrinks its ring.
PATCH = {
    "euroc_frontend": {"config": {"height": 96, "width": 128},
                       "traffic": {"ring": 8, "trace_frames": 6,
                                   "warm_frames": 2}},
    "raft_full_sintel": {"config": {"height": 64, "width": 64},
                         "traffic": {"ring": 4, "trace_frames": 2}},
}
SEED = 2 ** 31 + 12345


def spec():
    return harness.load_json(SPEC_PATH)


def config_of(spec_, workload):
    return {w["name"]: w for w in spec_["workloads"]}[workload]["config"]


def run(workload, seconds=0.5, trace=0, spec_=None, **kw):
    spec_ = spec_ or spec()
    return harness.run_cell(spec_, workload, SEED, seconds, trace, "cpu",
                            patch=PATCH[config_of(spec_, workload)], **kw)
