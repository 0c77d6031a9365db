"""The LM stack (the port's counterpart of ``repro.models``)."""
