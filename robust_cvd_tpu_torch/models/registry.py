"""Depth-model registry (reference monodepth/depth_model_registry.py:10-18).

A copy of robust_cvd_tpu/models/registry.py. The reference registers only
`midas2`, here the port's MidasV2Adapter. Adapters expose the requirement
attributes the CLI resolves from (`align`, `learning_rate`,
`lambda_view_baseline`, reference params.py:245-255) and batched
`estimate_depth`.
"""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_depth_model(name: str):
    if name not in _REGISTRY:
        # lazy-register builtins
        from .midas import MidasV2Adapter

        _REGISTRY.setdefault("midas2", MidasV2Adapter)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown depth model '{name}'; registered: {sorted(_REGISTRY)}"
        )


def get_depth_model_list():
    get_depth_model("midas2")  # ensure builtins registered
    return sorted(_REGISTRY)
