"""Autoregressive generation (the port's counterpart of ``repro.serve``)."""
