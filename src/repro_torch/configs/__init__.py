from repro_torch.configs.archs import ARCHS, get_config, smoke
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES, shapes_for

__all__ = ["ARCHS", "get_config", "smoke", "ModelConfig", "ShapeConfig",
           "SHAPES", "shapes_for"]
