"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the exact published config;
``get_config(arch_id).smoke()`` the reduced CPU smoke config.
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeSpec
from .musicgen_large import CONFIG as musicgen_large
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .grok1_314b import CONFIG as grok1_314b
from .granite_moe_1b import CONFIG as granite_moe_1b
from .qwen15_32b import CONFIG as qwen15_32b
from .olmo_1b import CONFIG as olmo_1b
from .gemma3_4b import CONFIG as gemma3_4b
from .nemotron4_15b import CONFIG as nemotron4_15b
from .internvl2_1b import CONFIG as internvl2_1b
from .jamba_v01_52b import CONFIG as jamba_v01_52b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [
        musicgen_large, falcon_mamba_7b, grok1_314b, granite_moe_1b,
        qwen15_32b, olmo_1b, gemma3_4b, nemotron4_15b, internvl2_1b,
        jamba_v01_52b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def arch_shape_cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells. ``long_500k`` only applies to
    sub-quadratic archs (SSM / hybrid / sliding-window) — see DESIGN.md
    section 7."""
    cells = []
    for name, cfg in REGISTRY.items():
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.subquadratic
            if skipped and not include_skipped:
                continue
            cells.append((name, shape.name, skipped))
    return cells


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "REGISTRY", "get_config",
           "arch_shape_cells"]
