from .base import SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeSpec, shape_applicable
from .registry import ARCHS, get_config

__all__ = ["SHAPES", "SHAPES_BY_NAME", "ModelConfig", "ShapeSpec",
           "shape_applicable", "ARCHS", "get_config"]
