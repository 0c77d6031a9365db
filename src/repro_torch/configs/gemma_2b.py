"""Per-arch config module (assigned architecture: see archs.py)."""
from repro_torch.configs.archs import GEMMA_2B as CONFIG
from repro_torch.configs.archs import smoke

SMOKE = smoke(CONFIG)
