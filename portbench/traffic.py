"""The one generator of requests, driven by a traffic mix's parameter file.

A mix (``portbench/traffic/<name>.json``) gives the number of closed-loop
clients, the distributions of prompt and output lengths, the share of
greedy requests and the sampling of the others, the engine's knobs for
that deployment, how the window opens (``ramp``) and closes (``drain``),
and what the check samples (``check``).

Lengths are drawn by strata so that every seed gives the same work: the
requests are taken in blocks of ``block``, and each block holds the
``block`` quantiles (i + 0.5) / block of each distribution in an order
drawn from the seed.  Prompt ids are drawn uniformly over the vocabulary
from the seed, so prompts share no prefix.  Randomness comes from numpy
generators keyed by (seed, stream, index), so request i is the same
whichever client sends it and whatever was drawn before it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

# streams of the (seed, stream, index) keys
_BLOCK, _IDS, _RAMP, _RAMP_IDS, _WARMUP_IDS = range(5)


@dataclasses.dataclass(frozen=True)
class Request:
    """One request of a mix: its prompt ids, the tokens it asks for,
    whether it is greedy, and the seed of its sampler."""
    index: int
    prompt: np.ndarray
    max_new: int
    greedy: bool
    seed: int


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of a length distribution, as ints:
    ``{"dist": "log_uniform" | "uniform", "lo", "hi"}`` or
    ``{"dist": "fixed", "value"}``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist['dist']
    if kind == 'fixed':
        return np.full(n, int(dist['value']), np.int64)
    if kind not in ('log_uniform', 'uniform'):
        raise ValueError(f'unknown length distribution {kind!r}')
    lo, hi = float(dist['lo']), float(dist['hi'])
    if kind == 'log_uniform':
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        v = lo + u * (hi - lo)
    return np.rint(v).astype(np.int64)


def length_max(dist: dict) -> int:
    return int(dist['value'] if dist['dist'] == 'fixed' else dist['hi'])


def _rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, stream, index])


class Traffic:
    """The requests of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(mix['clients'])
        self.block = int(mix.get('block', self.clients))
        self._blocks: dict = {}

    def _ids(self, stream: int, index: int, n: int) -> np.ndarray:
        return _rng(self.seed, stream, index).integers(
            0, self.vocab, n, dtype=np.int64).astype(np.int32)

    def _block_plan(self, b: int):
        plan = self._blocks.get(b)
        if plan is None:
            rng = _rng(self.seed, _BLOCK, b)
            n = self.block
            prompts = rng.permutation(quantiles(self.mix['prompt'], n))
            outputs = rng.permutation(quantiles(self.mix['output'], n))
            greedy = np.zeros(n, bool)
            greedy[rng.permutation(n)[:round(n * self.mix['greedy_share'])]] \
                = True
            seeds = rng.integers(0, 2 ** 31 - 1, n)
            plan = self._blocks[b] = (prompts, outputs, greedy, seeds)
        return plan

    def request(self, i: int) -> Request:
        """Request i of the mix's sequence."""
        prompts, outputs, greedy, seeds = self._block_plan(i // self.block)
        j = i % self.block
        return Request(i, self._ids(_IDS, i, int(prompts[j])),
                       int(outputs[j]), bool(greedy[j]), int(seeds[j]))

    def ramp_requests(self) -> List[Request]:
        """One request a client that brings the sessions in before the
        window: prompts from the mix's distribution, outputs from the
        ramp's, so that they end at staggered times (negative indices)."""
        ramp = self.mix['ramp']
        n = self.clients
        rng = _rng(self.seed, _RAMP, 0)
        prompts = rng.permutation(quantiles(self.mix['prompt'], n))
        outputs = rng.permutation(quantiles(ramp['output'], n))
        greedy = np.zeros(n, bool)
        greedy[rng.permutation(n)[:round(n * self.mix['greedy_share'])]] = True
        seeds = rng.integers(0, 2 ** 31 - 1, n)
        return [Request(-1 - c, self._ids(_RAMP_IDS, c, int(prompts[c])),
                        int(outputs[c]), bool(greedy[c]), int(seeds[c]))
                for c in range(n)]

    def warmup_requests(self) -> List[List[Request]]:
        """The warm-up's groups, each sent at once: ``{"prompt", "output",
        "count"}`` entries of the mix's ``warmup`` list (greedy)."""
        groups, k = [], 0
        for w in self.mix.get('warmup', []):
            group = []
            for _ in range(int(w['count'])):
                group.append(Request(-10_000 - k,
                                     self._ids(_WARMUP_IDS, k,
                                               int(w['prompt'])),
                                     int(w['output']), True, k))
                k += 1
            groups.append(group)
        return groups


def sampling_of(req: Request, mix: dict) -> dict:
    """The sampling a request asks for: the mix's ``sampling`` for a
    sampled request; top-k 1 and no penalty for a greedy one."""
    if req.greedy:
        return {'top_k': 1, 'top_p': 1.0, 'temperature': 1.0,
                'repetition_penalty': 1.0}
    return dict(mix['sampling'])


def worst_case_pages(mix: dict, page_size: int, step_length: int) -> int:
    """Pages that every client's longest request can hold at once: a
    session grows by up to a dispatch of ``step_length`` tokens past its
    context."""
    out = [length_max(mix['output'])]
    if 'output' in mix.get('ramp', {}):
        out.append(length_max(mix['ramp']['output']))
    tokens = length_max(mix['prompt']) + max(out) + step_length
    return int(mix['clients']) * -(-tokens // page_size)


__all__ = ['Request', 'Traffic', 'quantiles', 'length_max', 'sampling_of',
           'worst_case_pages']
