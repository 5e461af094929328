"""Depth-model registry (reference monodepth/depth_model_registry.py:10-18).

After robust_cvd_tpu/models/registry.py. The reference registers only
`midas2`, here the port's MidasV2Adapter; the port adds three more:
`dpt_large` (DPTLargeAdapter, MiDaS v3.0), `dpt_beit_large_512`
(DPTBeitLargeAdapter, MiDaS v3.1's BEiT-L/16-512) and `dpt_swin2_large_384`
(DPTSwin2LargeAdapter, MiDaS v3.1's SwinV2-L/24-384). All fill in
models/depth_model.py's contract.
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
        from .beit import DPTBeitLargeAdapter
        from .dpt import DPTLargeAdapter
        from .midas import MidasV2Adapter
        from .swin2 import DPTSwin2LargeAdapter

        _REGISTRY.setdefault("midas2", MidasV2Adapter)
        _REGISTRY.setdefault("dpt_large", DPTLargeAdapter)
        _REGISTRY.setdefault("dpt_beit_large_512", DPTBeitLargeAdapter)
        _REGISTRY.setdefault("dpt_swin2_large_384", DPTSwin2LargeAdapter)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown depth model '{name}'; registered: {sorted(_REGISTRY)}"
        )


def get_depth_model_list():
    get_depth_model("midas2")  # ensure builtins registered
    return sorted(_REGISTRY)
