"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "command-r-35b": "command_r_35b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "gemma3-1b": "gemma3_1b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-large-v3": "whisper_large_v3",
    "mamba2-780m": "mamba2_780m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, *, smoke: bool = False):
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG


def long_context_ok(arch: str) -> bool:
    return bool(getattr(_module(arch), "LONG_CONTEXT_OK", False))
