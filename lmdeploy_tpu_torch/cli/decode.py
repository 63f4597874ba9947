"""Prompt-logits / perplexity CLI.

Port of ``lmdeploy_tpu/cli/decode.py`` (reference:
lmdeploy/turbomind/decode.py): prompts go through
``EngineInstance.decode``; ``--ppl`` (the default) prints their
perplexity.

    python -m lmdeploy_tpu_torch.cli.decode <model_path> "text" ... \
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def main(model_path: str, prompts=None, input_file: str = '',
         ppl: bool = True, **engine_kw):
    """Prompt logits [n, max_len, vocab] of ``prompts`` and the lines of
    ``input_file``; ``engine_kw`` go to ``build_engine`` (``device``
    among them)."""
    from ..api import build_engine
    from ..pytorch.decode import perplexity

    engine = build_engine(model_path, **engine_kw)
    try:
        inst = engine.create_instance()
        texts = list(prompts or [])
        if input_file:
            with open(input_file) as f:
                texts.extend(line.strip() for line in f if line.strip())
        if not texts:
            texts = ['lmdeploy-tpu is a TPU-native inference engine.']

        token_lists = [engine.tokenizer.encode(t) for t in texts]
        max_len = max(len(t) for t in token_lists)
        all_logits = np.zeros((len(texts), max_len, engine.cfg.vocab_size),
                              np.float32)
        for i, ids in enumerate(token_lists):
            logits = inst.decode(ids)
            all_logits[i, :len(ids)] = logits
            print(f'prompt {i}: {len(ids)} tokens, logits {logits.shape}')
        if ppl:
            print(f'ppl: {perplexity(all_logits, token_lists):.4f}')
    finally:
        engine.shutdown()
    return all_logits


if __name__ == '__main__':
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch decode (prompt logits '
                                 '/ ppl)')
    ap.add_argument('model_path')
    ap.add_argument('prompts', nargs='*')
    ap.add_argument('--input-file', default='')
    ap.add_argument('--no-ppl', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu (plain versions)')
    a = ap.parse_args()
    main(a.model_path, a.prompts, a.input_file, ppl=not a.no_ppl,
         device=a.device)
