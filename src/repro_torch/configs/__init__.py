"""Architecture registry of the port: copies of ``repro.configs``' entries,
one module per architecture, and the paper's CNNs (``CNN_IDS``, built by
``models.cnn.CNNS``).

``get(name)`` returns the full-size ArchConfig; ``get_smoke(name)`` the
reduced same-family config used by the CPU tests and the CLI.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig  # noqa: F401

ARCH_IDS = ["deepseek-7b", "minitron-4b", "qwen1.5-4b", "phi3-medium-14b",
            "paligemma-3b", "whisper-base", "recurrentgemma-2b",
            "mamba2-2.7b", "deepseek-v2-236b", "deepseek-v3-671b"]

CNN_IDS = ["vgg16", "resnet18", "squeezenet"]


def _module(name: str):
    if name not in ARCH_IDS:
        raise ValueError(f"arch {name!r} is not ported yet; one of {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
