"""The demo drivers of the port: the counterparts of ``demos/*.py``.

Each demo runs on the card by default and is run from the repository root
as ``python -m feature_tracker_tpu_torch.demos.<name>_demo [--device cpu]
[--out DIR]``; ``run.sh`` runs them all. Each module's ``run`` takes the
demo's images and returns every number it prints (and its overlays by PNG
name); ``main`` loads the data (``_common.py``), calls ``run`` and writes
the PNGs under ``feature_tracker_tpu_torch/demos/output/`` or ``--out``.
"""
