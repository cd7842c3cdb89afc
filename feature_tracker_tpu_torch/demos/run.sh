#!/usr/bin/env bash
# Run every demo of the port serially, in demos/run.sh's order, from the
# repository root. PNGs go to feature_tracker_tpu_torch/demos/output/.
# Arguments go to every demo: run.sh --device cpu runs them on the CPU
# (the default device is the card).
set -e
cd "$(dirname "$0")/../.."

python3 -m feature_tracker_tpu_torch.demos.raft_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.track_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.dense_flow_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.direct_method_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.match_brief_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.match_superpoint_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.match_disk_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.nn_matcher_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.stream_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.slam_demo "$@"
python3 -m feature_tracker_tpu_torch.demos.cotracker_demo "$@"
