"""Serving engine, workload metrics and trace replay (the port's copy of ``repro.serving``)."""
