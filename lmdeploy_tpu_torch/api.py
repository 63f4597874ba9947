"""Top-level facade: build an engine from a converted workspace.

Port of ``lmdeploy_tpu/api.py::build_engine`` for workspaces (HF
directories, chat templates and tokenizers are later slices).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .config import EngineConfig
from .convert.workspace import is_workspace, load_workspace
from .engine.engine import TorchEngine, resolve_device


def build_engine(model_path: str,
                 engine_config: Optional[EngineConfig] = None,
                 device='cuda', quant_policy: Optional[int] = None,
                 **engine_kw) -> TorchEngine:
    """Load a workspace onto ``device`` (CUDA unless the caller asks for
    the CPU) and start the engine.  ``engine_config`` defaults to the
    workspace's, else one sized by the model's session_len.
    ``quant_policy`` overrides its KV-cache policy (0 bf16, 4 int8, 8 int4
    with calibrated scales); the workspace's ``kv_scales`` go to the
    engine."""
    if not is_workspace(model_path):
        raise ValueError(f'{model_path} is not a converted workspace '
                         '(config.json + weights.safetensors)')
    dev = resolve_device(device)
    cfg, ws_ecfg, params, kv_scales = load_workspace(model_path, dev)
    engine_config = engine_config or ws_ecfg \
        or EngineConfig(session_len=cfg.session_len)
    # replace re-runs __post_init__, which derives kv_dtype
    engine_config = dataclasses.replace(
        engine_config, **({} if quant_policy is None
                          else {'quant_policy': quant_policy}))
    return TorchEngine(cfg, engine_config, params, device=dev,
                       kv_scales=kv_scales, **engine_kw)


__all__ = ['build_engine']
