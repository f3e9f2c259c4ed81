"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .qwen2_5_32b import CONFIG as _qwen25_32b
from .stablelm_1_6b import CONFIG as _stablelm
from .qwen3_14b import CONFIG as _qwen3
from .mistral_nemo_12b import CONFIG as _nemo
from .qwen2_moe_a2_7b import CONFIG as _qwen2moe
from .arctic_480b import CONFIG as _arctic
from .musicgen_large import CONFIG as _musicgen
from .falcon_mamba_7b import CONFIG as _falcon_mamba
from .zamba2_1_2b import CONFIG as _zamba2
from .internvl2_1b import CONFIG as _internvl2

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (
    _qwen25_32b, _stablelm, _qwen3, _nemo, _qwen2moe,
    _arctic, _musicgen, _falcon_mamba, _zamba2, _internvl2,
)}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[:-len("-smoke")]).smoke()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
