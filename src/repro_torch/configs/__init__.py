"""Architecture registry: --arch <id> resolves here (copy of
``repro/configs/__init__.py``; the configurations are data)."""

from repro_torch.configs.base import (
    ArchConfig, SHAPES, ShapeConfig, shapes_for)
from repro_torch.configs import (
    granite_34b, jamba_v01_52b, llama4_maverick_400b, minicpm_2b,
    musicgen_medium, nemotron_4_340b, pixtral_12b, qwen3_moe_30b,
    rwkv6_3b, stablelm_12b)

_MODULES = {
    "nemotron-4-340b": nemotron_4_340b,
    "granite-34b": granite_34b,
    "stablelm-12b": stablelm_12b,
    "minicpm-2b": minicpm_2b,
    "jamba-v0.1-52b": jamba_v01_52b,
    "rwkv6-3b": rwkv6_3b,
    "musicgen-medium": musicgen_medium,
    "pixtral-12b": pixtral_12b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
}

ARCHS: dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return _MODULES[name].reduced() if reduced else ARCHS[name]


def all_arch_names() -> list[str]:
    return list(_MODULES)


__all__ = ["ArchConfig", "SHAPES", "ShapeConfig", "shapes_for", "ARCHS",
           "get_arch", "all_arch_names"]
