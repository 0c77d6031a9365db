"""Per-arch config module (assigned architecture: see archs.py)."""
from repro_torch.configs.archs import MUSICGEN_MEDIUM as CONFIG
from repro_torch.configs.archs import smoke

SMOKE = smoke(CONFIG)
