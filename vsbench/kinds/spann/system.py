"""SPANN's system under test: ``vsbench/system.py``'s ``Program``."""
from vsbench.system import Program  # noqa: F401
