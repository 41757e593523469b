"""Architecture registry — importing this package registers all configs."""
from . import (llama32_3b, mamba2_27b, olmoe_1b_7b, paligemma_3b,
               qwen2_moe_a27b, qwen3_4b, seamless_m4t_medium, smollm_135m,
               yi_34b, zamba2_7b)
from . import ring_rpq
from .base import (SHAPES, ModelConfig, ShapeSpec, get_config, list_configs,
                   shape_applicable, smoke_variant)

ALL_ARCHS = [
    "yi-34b", "qwen3-4b", "llama3.2-3b", "smollm-135m",
    "qwen2-moe-a2.7b", "olmoe-1b-7b", "mamba2-2.7b", "paligemma-3b",
    "zamba2-7b", "seamless-m4t-medium",
]
