"""Block caches (the port's copy of ``repro.cache``)."""
