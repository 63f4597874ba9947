"""Calibration data loaders.

Copy of ``lmdeploy_tpu/lite/utils/calib_dataloader.py`` that tokenizes
with the port's ``tokenizer.py`` (its ``Tokenizer`` is called as the JAX
package calls an HF tokenizer: special tokens included).  Reference:
lmdeploy/lite/utils/calib_dataloader.py loads c4 / wikitext2 / ptb /
pileval via HuggingFace datasets.  Here the named datasets import
``datasets`` inside :func:`get_calib_loaders`, as the JAX package does,
resolve through the local HF cache only (offline mode) and raise without
the package; two sources need no package: ``file:<path>`` (any text file
/ directory of .txt) and ``synthetic`` (deterministic pseudo-text for
smoke tests)."""
from __future__ import annotations

import os.path as osp
import random
from typing import List


def _chunks_from_text(text: str, tokenizer, nsamples: int, seqlen: int):
    import torch
    enc = tokenizer(text)
    enc = enc['input_ids'] if not isinstance(enc, list) else enc
    enc = torch.as_tensor(enc, dtype=torch.long).reshape(1, -1)
    rng = random.Random(0)
    out = []
    if enc.shape[1] <= seqlen:
        reps = -(-(nsamples * seqlen) // max(1, enc.shape[1]))
        enc = torch.cat([enc] * (reps + 1), dim=1)
    for _ in range(nsamples):
        start = rng.randint(0, enc.shape[1] - seqlen - 1)
        out.append(enc[:, start:start + seqlen])
    return out


def _synthetic_text(n_chars: int = 200000) -> str:
    rng = random.Random(0)
    words = ['the', 'model', 'quantization', 'tensor', 'processing',
             'unit', 'activation', 'weight', 'scale', 'cache', 'token',
             'attention', 'layer', 'matrix', 'memory', 'compute',
             'language', 'inference', 'serving', 'throughput']
    out = []
    total = 0
    while total < n_chars:
        sent = ' '.join(rng.choices(words, k=rng.randint(5, 15))) + '. '
        out.append(sent)
        total += len(sent)
    return ''.join(out)


def get_calib_loaders(name: str, tokenizer, nsamples: int = 128,
                      seqlen: int = 2048) -> List:
    """Return a list of torch LongTensor [1, seqlen] calibration samples.

    name: 'c4' | 'wikitext2' | 'ptb' | 'pileval' (needs local HF cache),
    'file:<path>', or 'synthetic'.
    """
    if name == 'synthetic':
        return _chunks_from_text(_synthetic_text(), tokenizer, nsamples,
                                 seqlen)
    if name.startswith('file:'):
        path = name[5:]
        if osp.isdir(path):
            import glob
            text = '\n\n'.join(
                open(f, errors='replace').read()
                for f in sorted(glob.glob(osp.join(path, '*.txt'))))
        else:
            text = open(path, errors='replace').read()
        return _chunks_from_text(text, tokenizer, nsamples, seqlen)

    # HF datasets path (works offline against the local cache only)
    from datasets import load_dataset  # noqa: PLC0415
    specs = {
        'wikitext2': ('wikitext', 'wikitext-2-raw-v1', 'train', 'text'),
        'ptb': ('ptb_text_only', 'penn_treebank', 'train', 'sentence'),
        'c4': ('allenai/c4', 'en', 'train', 'text'),
        'pileval': ('mit-han-lab/pile-val-backup', None, 'validation',
                    'text'),
    }
    if name not in specs:
        raise ValueError(f'unknown calib dataset {name!r}; use one of '
                         f'{sorted(specs)} or file:<path> or synthetic')
    ds_name, cfg, split, field = specs[name]
    ds = load_dataset(ds_name, cfg, split=split)
    text = '\n\n'.join(ds[field][:nsamples * 8])
    return _chunks_from_text(text, tokenizer, nsamples, seqlen)


__all__ = ['get_calib_loaders']
