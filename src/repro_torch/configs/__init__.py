"""Architecture configs ported from the JAX package (this slice needs only
smollm-360m)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ShapeConfig, \
    SHAPES, shape_applicable

__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "shape_applicable"]
