"""Synthetic dataset analogues (the port's copy of ``repro.data``)."""
