"""Top-level facade: build an engine from a model path.

Port of ``lmdeploy_tpu/api.py::build_engine``: loads a converted
workspace, or an HF or meta-llama checkpoint directory (bf16 dense
weights), onto the device, applies the caller's overrides, resolves the
chat template and its stop words, and starts the engine.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Optional

import torch

from .config import EngineConfig
from .convert.hf import load_hf_dir
from .convert.workspace import (is_workspace, load_workspace,
                                params_from_numpy)
from .engine.engine import TorchEngine, resolve_device
from .model import MODELS, best_match_model
from .tokenizer import DummyTokenizer, Tokenizer


def _resolve_tokenizer(model_path: str, vocab_size: int):
    """The workspace's tokenizer files through ``transformers`` or
    ``tiktoken``; :class:`DummyTokenizer` when there are none or they do
    not load (a machine without those packages)."""
    for probe in ('tokenizer.json', 'tokenizer.model',
                  'tokenizer_config.json'):
        if osp.exists(osp.join(model_path, probe)):
            try:
                return Tokenizer(model_path)
            except Exception:
                break
    return DummyTokenizer(vocab_size=vocab_size)


def build_engine(model_path: str,
                 engine_config: Optional[EngineConfig] = None,
                 model_name: str = '', tp: int = 1, pp: int = 1,
                 dp: int = 1, quant_policy: Optional[int] = None,
                 speculative_k: Optional[int] = None, device='cuda',
                 **engine_kw) -> TorchEngine:
    """Load a workspace, or an HF / meta-llama directory as bf16 dense
    weights, onto ``device`` (CUDA unless the caller asks for the CPU)
    and start the engine.  ``engine_config`` defaults to the workspace's,
    else one sized by the model's session_len.
    ``quant_policy`` (0 bf16, 4 int8, 8 int4 with calibrated scales) and
    ``speculative_k`` (0 turns speculation off) override the resolved
    config; ``tp`` / ``pp`` / ``dp`` above 1 raise the engine's
    NotImplementedError.  The template comes from ``model_name``, the
    config's ``model_name`` or the path; its stop words become the
    engine's defaults."""
    dev = resolve_device(device)
    if is_workspace(model_path):
        cfg, ws_ecfg, params, kv_scales = load_workspace(model_path, dev)
    else:
        # runtime weights in bf16: f32 would double device memory and the
        # bytes each decode step reads
        cfg, params = load_hf_dir(model_path, torch.bfloat16)
        params, ws_ecfg, kv_scales = params_from_numpy(params, dev), None, None
    engine_config = engine_config or ws_ecfg \
        or EngineConfig(session_len=cfg.session_len)
    over = {name: max(getattr(engine_config, name), v)
            for name, v in (('tp', tp), ('pp', pp), ('dp', dp)) if v > 1}
    if quant_policy is not None:
        over['quant_policy'] = quant_policy
    if speculative_k is not None:
        over['speculative_k'] = speculative_k
    # replace re-runs __post_init__, which derives kv_dtype
    engine_config = dataclasses.replace(engine_config, **over)

    name = model_name or cfg.model_name
    template_name = name if name in MODELS.module_dict else \
        (best_match_model(name) or best_match_model(model_path) or 'base')
    template = MODELS.get(template_name)()
    engine = TorchEngine(cfg, engine_config, params, device=dev,
                         kv_scales=kv_scales,
                         tokenizer=_resolve_tokenizer(model_path,
                                                      cfg.vocab_size),
                         stop_words=template.stop_words or [], **engine_kw)
    engine.chat_template = template
    engine.template_name = template_name
    return engine


__all__ = ['build_engine']
