"""Architecture config registry: ``get(name)`` / ``names()`` / ``smoke(name)``.

One module per assigned architecture; each exposes ``CONFIG`` (the exact
published config) and ``smoke()`` (a reduced same-family config for CPU
tests)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "h2o_danube3_4b",
    "stablelm_3b",
    "granite_3_2b",
    "nemotron_4_15b",
    "musicgen_large",
    "internvl2_76b",
    "grok_1_314b",
    "llama4_maverick_400b",
    "mamba2_370m",
    "recurrentgemma_2b",
)

# accept dashed ids from the assignment table too
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES["llama4-maverick-400b-a17b"] = "llama4_maverick_400b"
_ALIASES["h2o-danube-3-4b"] = "h2o_danube3_4b"
_ALIASES["recurrentgemma-2b"] = "recurrentgemma_2b"


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


def names() -> tuple[str, ...]:
    return ARCHS
