"""Benchmark of the PyTorch/CUDA port ``repro_torch`` on one card.

``python vsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix, metric or index kind is a file of its own
under ``configs/``, ``traffic/``, ``checks/``, ``metrics/`` and
``kinds/<index>/``, found by the name that ``BENCHMARK.json`` or the
configuration gives it.  ``datagen.py``, ``work.py``, ``reference/`` and
each kind's ``kind.py`` and ``reference.py`` are the yardstick and import
nothing of the port.
"""
