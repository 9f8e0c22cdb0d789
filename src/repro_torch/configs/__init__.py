from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES
from repro_torch.configs.archs import ARCHS, SMOKE_ARCHS, smoke_variant
