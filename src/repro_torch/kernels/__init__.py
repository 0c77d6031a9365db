"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the device dispatch (:mod:`repro_torch.kernels.ops`)."""
