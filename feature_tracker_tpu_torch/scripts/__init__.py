"""The timing and evaluation scripts of the port: the counterparts of
``scripts/raft_bf16_eval.py``, ``time_klt_modes.py``, ``klt_multipair.py``
and ``cotracker_r5_sweep.sh``.

Each runs on the card by default, from the repository root, as ``python -m
feature_tracker_tpu_torch.scripts.<name> ... [--device cpu]``. Each mode is
a function that takes the JAX script's sizes as keyword arguments, with its
values as defaults, and returns the dict it prints. Times follow
``_timing.py``; no script writes under ``weights/``.
"""
