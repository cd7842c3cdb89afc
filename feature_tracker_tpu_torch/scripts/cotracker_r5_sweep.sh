#!/bin/sh
# The round-5 CoTracker sweep of scripts/cotracker_r5_sweep.sh, on the
# port's trainer (train/cotracker_pretrain.py; default device the card):
# the real-data and capacity levers with the time encoding off, and the
# encoding once more at half the learning rate. The trainer's gate
# (held-out EPE below the recorded one) decides whether a run writes
# weights/cotracker.npz and weights/metrics.json, as in the JAX trainer.
# Each run's last four lines go to the log (default
# /tmp/cotracker_sweep.log).
set -x
cd "$(dirname "$0")/../.."
LOG=${1:-/tmp/cotracker_sweep.log}
run() {
  echo "=== $* ===" >> "$LOG"
  timeout 2400 python3 -m feature_tracker_tpu_torch.train.cotracker_pretrain \
    "$@" 2>&1 | tail -4 >> "$LOG"
}
# (1) the real-video lever alone on the r4-best recipe
run steps=3000 lr_micro=50 batch=2 time_enc=0 real_pct=30
run steps=3000 lr_micro=50 batch=2 time_enc=0 real_pct=50
# (2) capacity at batch 4 (r4: batch 4 tolerates 1e-4)
run steps=3000 lr_micro=100 batch=4 time_enc=0 real_pct=30 \
  model_dim=192 depth=3
# (3) time encoding stability retry at half LR
run steps=3000 lr_micro=25 batch=2 time_enc=1 real_pct=30
echo done >> "$LOG"
