"""Batched prompt logits over HF eager — the perplexity oracle.

Port of ``lmdeploy_tpu/pytorch/decode.py`` (reference:
lmdeploy/pytorch/decode.py:155 Engine, which splits token batches across
GPUs and returns per-position logits / ppl).  :class:`Engine` runs one
HF model on ``device`` (CUDA unless the caller asks for the CPU);
:func:`perplexity` is also what ``cli/decode.py`` uses on the port
engine's prompt logits.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..engine.engine import resolve_device
from . import require_transformers


class Engine:
    """Batched decode of prompt logits with padding (right-aligned mask)
    on ``device``."""

    def __init__(self, model_path: str, tokenizer_path: str = '',
                 dtype=None, device='cuda'):
        transformers = require_transformers()
        self.device = resolve_device(device)
        self.model = transformers.AutoModelForCausalLM.from_pretrained(
            model_path, torch_dtype=dtype or torch.float32,
            trust_remote_code=True).eval().to(self.device)

    def decode(self, token_ids: List[List[int]], max_bs: int = 8,
               pad_token_id: int = 0) -> np.ndarray:
        """Returns f32 logits [n, max_len, vocab] (padded positions
        zeroed)."""
        n = len(token_ids)
        max_len = max(len(t) for t in token_ids)
        out = None
        for s in range(0, n, max_bs):
            chunk = token_ids[s:s + max_bs]
            ids = torch.full((len(chunk), max_len), pad_token_id,
                             dtype=torch.long)
            mask = torch.zeros((len(chunk), max_len), dtype=torch.long)
            for i, t in enumerate(chunk):
                ids[i, :len(t)] = torch.as_tensor(t)
                mask[i, :len(t)] = 1
            ids, mask = ids.to(self.device), mask.to(self.device)
            with torch.no_grad():
                logits = self.model(ids, attention_mask=mask).logits
            logits = logits * mask[..., None]
            arr = logits.float().cpu().numpy()
            out = arr if out is None else np.concatenate([out, arr])
        return out


def perplexity(logits: np.ndarray, token_ids: List[List[int]]) -> float:
    """Token-level ppl of prompt logits [n, max_len, vocab] (teacher
    forcing: row t predicts token t + 1)."""
    nll, count = 0.0, 0
    for i, toks in enumerate(token_ids):
        if len(toks) < 2:
            continue
        lg = torch.from_numpy(logits[i, :len(toks) - 1])
        tgt = torch.as_tensor(toks[1:])
        nll += torch.nn.functional.cross_entropy(
            lg, tgt, reduction='sum').item()
        count += len(toks) - 1
    return float(np.exp(nll / max(count, 1)))


__all__ = ['Engine', 'perplexity']
