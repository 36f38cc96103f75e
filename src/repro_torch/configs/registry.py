"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES: dict[str, str] = {
    "yi-34b": "repro_torch.configs.yi_34b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def _module(arch: str):
    try:
        return importlib.import_module(_MODULES[arch])
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}") from None


def get_config(arch: str) -> ArchConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()
