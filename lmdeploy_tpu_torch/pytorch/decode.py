"""Perplexity from prompt logits.

Port of ``lmdeploy_tpu/pytorch/decode.py::perplexity`` (:48-60), which
``cli/decode.py`` needs.  The HF eager ``Engine`` of that file is not
ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


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


__all__ = ['perplexity']
