"""Tokenizer wrapper with incremental (streaming) detokenization.

Copy of ``lmdeploy_tpu/tokenizer.py`` (no JAX in it; the port imports
nothing of the JAX package).  ``transformers`` and ``tiktoken`` are
imported only inside the classes that need them, so a machine without
them serves with :class:`DummyTokenizer`.  Behavior-parity rebuild of the reference tokenizer layer
(reference: lmdeploy/turbomind/tokenizer.py): HF tokenizers backend,
``<BOS>``/``<EOS>`` markers consumed at encode time, and prefix-space
fixup for incremental decoding of sentencepiece-style vocabularies.

sentencepiece is not a dependency here; HF ``transformers`` covers both
fast and slow tokenizers (the slow path wraps sentencepiece models).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import List, Optional, Sequence


class HuggingFaceTokenizer:
    """Wraps ``transformers.AutoTokenizer`` for a model directory."""

    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer
        self.model = AutoTokenizer.from_pretrained(model_dir,
                                                   trust_remote_code=True)
        self._no_prefix_space_tokens: Optional[set] = None
        self._heading_space_symbol = '▁'  # sentencepiece "▁"

    @property
    def vocab_size(self) -> int:
        return self.model.vocab_size

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.model.bos_token_id

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.model.eos_token_id

    @property
    def no_prefix_space_tokens(self) -> set:
        """Token ids whose piece does not start a new word (no leading '▁')."""
        if self._no_prefix_space_tokens is None:
            vocab = self.model.convert_ids_to_tokens(list(range(self.vocab_size)))
            self._no_prefix_space_tokens = {
                i for i, tok in enumerate(vocab)
                if tok and not tok.startswith(self._heading_space_symbol)
            }
        return self._no_prefix_space_tokens

    def indexes_containing_token(self, token: str) -> List[int]:
        """Every vocab id whose PIECE TEXT contains ``token`` — the
        vocab-scan stop-word expansion (reference behavior:
        lmdeploy/turbomind/tokenizer.py; a stop word like '<eoa>' may be
        merged inside larger pieces, and any of those pieces ending the
        stream must trigger the stop)."""
        if not hasattr(self, '_piece_text'):
            vocab = self.model.convert_ids_to_tokens(
                list(range(self.vocab_size)))
            self._piece_text = [
                (tok or '').replace(self._heading_space_symbol, ' ')
                for tok in vocab]
            self._containing_cache = {}
        # the O(vocab) Python scan sits on the per-request serving path —
        # memoize per stop string (the vocab never changes)
        hit = self._containing_cache.get(token)
        if hit is None:
            hit = [i for i, txt in enumerate(self._piece_text)
                   if token in txt]
            self._containing_cache[token] = hit
        return hit

    def _maybe_add_prefix_space(self, tokens: Sequence[int], decoded: str) -> str:
        if len(tokens) and not decoded.startswith(' ') \
                and tokens[0] not in self.no_prefix_space_tokens:
            return ' ' + decoded
        return decoded

    def encode(self, s: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = self.model.encode(s, add_special_tokens=False)
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        if add_eos and self.eos_token_id is not None:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, t: Sequence[int], offset: Optional[int] = None) -> str:
        t = list(t)
        new = t[offset:] if offset else t
        out = self.model.decode(new, skip_special_tokens=False)
        if offset:
            out = self._maybe_add_prefix_space(new, out)
        return out

    def __call__(self, s):
        return self.model(s)


# qwen's tiktoken setup (public tokenization_qwen.py; the reference
# special-cases this vocab in deploy.py:786-913)
_QWEN_PAT = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"""
             r"""|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"""
             r"""|\s+""")
_QWEN_SPECIALS = (['<|endoftext|>', '<|im_start|>', '<|im_end|>']
                  + [f'<|extra_{i}|>' for i in range(205)])


class TiktokenTokenizer:
    """Native tiktoken backend for qwen-style ``*.tiktoken`` vocab files —
    no ``trust_remote_code`` execution needed (the reference instead
    reads the tiktoken vocab in deploy.py:786-913 to rebuild its
    tokenizer tables).  Byte-level BPE: no sentencepiece prefix-space
    fixup applies."""

    def __init__(self, model_dir: str):
        import base64
        import glob

        import tiktoken
        vf = sorted(glob.glob(osp.join(model_dir, '*.tiktoken')))[0]
        ranks = {}
        with open(vf, 'rb') as f:
            for line in f:
                if not line.strip():
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        self._special = {t: len(ranks) + i
                         for i, t in enumerate(_QWEN_SPECIALS)}
        self.model = tiktoken.Encoding(
            osp.basename(vf), pat_str=_QWEN_PAT, mergeable_ranks=ranks,
            special_tokens=self._special)
        self._containing_cache = {}

    @property
    def vocab_size(self) -> int:
        return self.model.n_vocab

    @property
    def bos_token_id(self) -> Optional[int]:
        return None                      # qwen has no BOS

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._special['<|endoftext|>']

    def encode(self, s: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        # chat templates embed <|im_start|>/<|im_end|> markers — allow all
        ids = self.model.encode(s, allowed_special='all')
        if add_eos and self.eos_token_id is not None:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, t: Sequence[int], offset: Optional[int] = None) -> str:
        new = list(t)[offset or 0:]
        return self.model.decode(new, errors='replace')

    def _piece(self, i: int) -> str:
        try:
            return self.model.decode_single_token_bytes(i).decode(
                'utf-8', errors='replace')
        except KeyError:
            return ''

    def indexes_containing_token(self, token: str) -> List[int]:
        hit = self._containing_cache.get(token)
        if hit is None:
            hit = [i for i in range(self.model.n_vocab)
                   if token in self._piece(i)]
            self._containing_cache[token] = hit
        return hit

    def __call__(self, s):
        return {'input_ids': self.encode(s)}


def _has_tiktoken_vocab(model_dir: str) -> bool:
    import glob
    return bool(glob.glob(osp.join(model_dir, '*.tiktoken')))


class Tokenizer:
    """Facade that consumes ``<BOS>``/``<EOS>`` markers from chat templates
    (reference: lmdeploy/turbomind/tokenizer.py:59-69)."""

    def __init__(self, model_path: str):
        if osp.isdir(model_path):
            model_dir = model_path
        else:
            model_dir = osp.dirname(model_path) or '.'
        if _has_tiktoken_vocab(model_dir):
            self.model = TiktokenTokenizer(model_dir)
        else:
            self.model = HuggingFaceTokenizer(model_dir)

    @property
    def vocab_size(self) -> int:
        return self.model.vocab_size

    @property
    def bos_token_id(self):
        return self.model.bos_token_id

    @property
    def eos_token_id(self):
        return self.model.eos_token_id

    def encode(self, s: str) -> List[int]:
        add_bos = False
        add_eos = False
        if '<BOS>' in s:
            s = s.replace('<BOS>', '')
            add_bos = True
        if s == '<EOS>':
            s = ''
            add_eos = True
        return self.model.encode(s, add_bos=add_bos, add_eos=add_eos)

    def decode(self, t: Sequence[int], offset: Optional[int] = None) -> str:
        return self.model.decode(t, offset)

    def indexes_containing_token(self, token: str) -> List[int]:
        """All vocab ids whose piece text CONTAINS ``token`` — vocab-scan
        stop-word expansion (reference: lmdeploy/turbomind/tokenizer.py).
        Falls back to the exact single-token encoding for backends
        without a piece vocabulary."""
        scan = getattr(self.model, 'indexes_containing_token', None)
        if scan is not None:
            ids = scan(token)
            if ids:
                return ids
        encoded = self.model.encode(token, add_bos=False)
        if len(encoded) > 1:
            return []
        return encoded

    def stop_sequences_for(self, words: Sequence[str]) -> List[List[int]]:
        """Expand stop *strings* into engine stop sequences: single-token
        matches (incl. vocab-scan containment hits) become 1-token stops;
        strings that only encode to >1 token become multi-token stop
        sequences (the engine's host-side stop_sequences matcher) instead
        of being silently dropped."""
        out: List[List[int]] = []
        for w in words:
            singles = self.indexes_containing_token(w)
            out.extend([s] for s in singles)
            ids = self.model.encode(w, add_bos=False)
            # the stop string can also be emitted ACROSS token boundaries
            # (e.g. "\n\n" as two "\n" tokens) — always register the
            # multi-token encoding too, not only when no piece contains it
            if len(ids) > 1 or (ids and not singles):
                out.append(list(ids))
        return out

    def __call__(self, s):
        return self.model(s)


class DummyTokenizer:
    """A trivial whitespace/byte tokenizer for tests and random-weight
    benchmarks where no real tokenizer files exist."""

    def __init__(self, vocab_size: int = 32000, bos_id: int = 1, eos_id: int = 2):
        self._vocab_size = vocab_size
        self._bos = bos_id
        self._eos = eos_id

    @property
    def vocab_size(self):
        return self._vocab_size

    @property
    def bos_token_id(self):
        return self._bos

    @property
    def eos_token_id(self):
        return self._eos

    def encode(self, s: str) -> List[int]:
        add_bos = '<BOS>' in s
        s = s.replace('<BOS>', '')
        ids = [(3 + (b % (self._vocab_size - 3))) for b in s.encode('utf-8')]
        return ([self._bos] if add_bos else []) + ids

    def decode(self, t: Sequence[int], offset: Optional[int] = None) -> str:
        t = list(t)[offset or 0:]
        body = bytes((max(0, i - 3) % 256) for i in t if i > 2)
        return body.decode('utf-8', errors='replace')

    def indexes_containing_token(self, token: str) -> List[int]:
        ids = self.encode(token)
        return ids if len(ids) == 1 else []

    def stop_sequences_for(self, words: Sequence[str]) -> List[List[int]]:
        out = []
        for w in words:
            ids = self.encode(w)
            if ids:
                out.append(list(ids))
        return out
