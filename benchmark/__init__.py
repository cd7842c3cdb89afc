"""The benchmark of the PyTorch/CUDA port (``feature_tracker_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json`` and ``configs/<config>.py``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``.
"""
