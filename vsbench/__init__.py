"""Benchmark of the PyTorch/CUDA port ``repro_torch`` on one card.

``python vsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix or metric is a file of its own under
``configs/``, ``traffic/`` and ``metrics/``, found by the name that
``BENCHMARK.json`` gives it.  ``datagen.py``, ``work.py`` and ``reference/``
are the yardstick and import nothing of the port.
"""
