"""Training: AdamW, the train step, checkpoints and the fault-tolerant
runner (counterpart of ``repro.train``)."""
