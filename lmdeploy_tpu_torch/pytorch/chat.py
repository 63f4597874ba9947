"""Terminal chat over the HF eager baseline.

Port of ``lmdeploy_tpu/pytorch/chat.py`` (reference:
lmdeploy/pytorch/chat.py:84): loads an HF causal LM on ``device`` (CUDA
unless the caller asks for the CPU), applies the chat template, streams
tokens and keeps session history.  Unlike the JAX version,
:func:`generate_stream` draws its samples from an explicit
``torch.Generator`` instead of the global one."""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from ..engine.engine import resolve_device
from ..model import MODELS, best_match_model
from . import require_transformers
from .session import BasicSessionManagerWithHistory


def generate_stream(model, tokenizer, input_ids, max_new_tokens=512,
                    temperature=1.0, top_k=40, top_p=0.8,
                    repetition_penalty=1.0, greedy=False, device='cuda',
                    generator: Optional[torch.Generator] = None):
    """Token-by-token HF generate (yields token ids) on ``device``, where
    the model lives; samples are drawn from ``generator`` (on ``device``;
    a generator seeded by the OS when None)."""
    dev = resolve_device(device)
    if generator is None and not greedy:
        generator = torch.Generator(device=dev)
        generator.seed()
    ids = torch.as_tensor(input_ids, device=dev)[None]
    past = None
    eos = tokenizer.eos_token_id
    with torch.no_grad():
        for _ in range(max_new_tokens):
            out = model(ids if past is None else ids[:, -1:],
                        past_key_values=past, use_cache=True)
            past = out.past_key_values
            logits = out.logits[0, -1]
            if repetition_penalty != 1.0:
                seen = torch.unique(ids[0])
                pen = logits[seen]
                logits[seen] = torch.where(pen > 0,
                                           pen / repetition_penalty,
                                           pen * repetition_penalty)
            if greedy:
                tok = int(logits.argmax())
            else:
                logits = logits / max(temperature, 1e-5)
                if top_k > 0:
                    kth = torch.topk(logits, min(top_k, logits.numel()))[0][-1]
                    logits[logits < kth] = float('-inf')
                probs = torch.softmax(logits, -1)
                if top_p < 1.0:
                    sp, si = probs.sort(descending=True)
                    keep = (sp.cumsum(0) - sp) < top_p
                    mask = torch.zeros_like(probs, dtype=torch.bool)
                    mask[si[keep]] = True
                    probs = torch.where(mask, probs, torch.zeros_like(probs))
                    probs = probs / probs.sum()
                tok = int(torch.multinomial(probs, 1, generator=generator))
            yield tok
            if eos is not None and tok == eos:
                return
            ids = torch.cat([ids, torch.tensor([[tok]], device=dev)], dim=1)


def main(model_path: str, model_name: str = '', max_new_tokens: int = 512,
         temperature: float = 0.8, top_k: int = 40, top_p: float = 0.8,
         repetition_penalty: float = 1.0, max_session_len: int = 2048,
         device='cuda'):
    transformers = require_transformers()
    dev = resolve_device(device)
    tokenizer = transformers.AutoTokenizer.from_pretrained(
        model_path, trust_remote_code=True)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        model_path, torch_dtype=torch.float32,
        trust_remote_code=True).eval().to(dev)
    generator = torch.Generator(device=dev)
    generator.seed()
    name = model_name or best_match_model(model_path) or 'base'
    template = MODELS.get(name)()
    sm = BasicSessionManagerWithHistory(max_session_len=max_session_len)
    print(f'[pytorch baseline] template={name}; "exit" to quit, '
          f'"clear" to reset session')
    while True:
        try:
            prompt = input('\n>>> ')
        except EOFError:
            break
        if prompt == 'exit':
            break
        if prompt == 'clear':
            sm.new_session()
            continue
        text = template.get_prompt(prompt, sequence_start=not sm.history)
        input_ids = tokenizer.encode(text.replace('<BOS>', ''))
        input_ids = sm.prepend_history(input_ids)
        out_ids = []
        printed = 0
        for tok in generate_stream(model, tokenizer, input_ids,
                                   max_new_tokens, temperature, top_k,
                                   top_p, repetition_penalty, device=dev,
                                   generator=generator):
            out_ids.append(tok)
            txt = tokenizer.decode(out_ids)
            print(txt[printed:], end='', flush=True)
            printed = len(txt)
        print()
        sm.add_to_history(out_ids)


def cli():
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.pytorch chat baseline')
    ap.add_argument('model_path')
    ap.add_argument('--model-name', default='')
    ap.add_argument('--max-new-tokens', type=int, default=512)
    ap.add_argument('--temperature', type=float, default=0.8)
    ap.add_argument('--top-k', type=int, default=40)
    ap.add_argument('--top-p', type=float, default=0.8)
    ap.add_argument('--repetition-penalty', type=float, default=1.0)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    main(a.model_path, a.model_name, a.max_new_tokens, a.temperature,
         a.top_k, a.top_p, a.repetition_penalty, device=a.device)


if __name__ == '__main__':
    cli()
