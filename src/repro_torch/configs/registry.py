"""Registry: ``--arch <id>`` resolution for models and registration configs."""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig, RegistrationConfig

from . import (
    qwen1_5_0_5b,
    smollm_135m,
    qwen2_7b,
    phi3_medium_14b,
    whisper_large_v3,
    olmoe_1b_7b,
    deepseek_moe_16b,
    internvl2_1b,
    mamba2_780m,
    jamba_v01_52b,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen1_5_0_5b,
        smollm_135m,
        qwen2_7b,
        phi3_medium_14b,
        whisper_large_v3,
        olmoe_1b_7b,
        deepseek_moe_16b,
        internvl2_1b,
        mamba2_780m,
        jamba_v01_52b,
    )
}

#: The paper's own workload, registered alongside the LM pool. claire_<N>
#: registers two N^3 images with the paper's default solver settings;
#: ``ensemble`` models the population-study batch (embarrassingly parallel
#: registrations — the paper's motivating clinical workflow).
REGISTRATIONS: Dict[str, RegistrationConfig] = {
    f"claire_{n}": RegistrationConfig(name=f"claire_{n}", grid=(n, n, n))
    for n in (64, 128, 256, 384)
}
REGISTRATIONS["claire_256_ensemble"] = RegistrationConfig(
    name="claire_256_ensemble", grid=(256, 256, 256), ensemble=256)


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_registration(name: str) -> RegistrationConfig:
    if name not in REGISTRATIONS:
        raise KeyError(
            f"unknown registration config {name!r}; available: {sorted(REGISTRATIONS)}")
    return REGISTRATIONS[name]


def list_archs():
    return sorted(ARCHS)
