"""Launch drivers (the port's counterpart of ``repro.launch``)."""
