"""Per-arch config module (assigned architecture: see archs.py)."""
from repro_torch.configs.archs import MOONSHOT_16B_A3B as CONFIG
from repro_torch.configs.archs import smoke

SMOKE = smoke(CONFIG)
