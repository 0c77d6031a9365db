"""Per-arch config module (assigned architecture: see archs.py)."""
from repro_torch.configs.archs import STARCODER2_7B as CONFIG
from repro_torch.configs.archs import smoke

SMOKE = smoke(CONFIG)
