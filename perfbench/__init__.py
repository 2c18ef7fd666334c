"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once and prints one JSON line::

    python3 perfbench/run.py --workload fm7b.fedtrain --seed 7 \
        --seconds 40 --trace 0

``BENCHMARK.json`` at the repository's root names the cells, and the
harness finds each cell's parts by name: the configuration in
``perfbench/configs/<config>.json``, the traffic mix in
``perfbench/traffic/<traffic>.json`` (which names its driver under
``perfbench/drivers/``), the correctness limits in
``perfbench/limits/<cell>.json`` and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``.  A new cell, configuration, mix or
metric is new files and new manifest entries; no file here is edited.

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
