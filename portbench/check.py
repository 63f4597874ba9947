"""Whether what the timed path served is correct.

Once the window has closed and the engine is gone, a sample drawn from
the seed of the requests that finished (the longest, prompt and served
tokens, always in it, and the longest greedy one) is run through the
plain reference of the configuration's model family (the ``forward`` of
its ``families/<family>_reference.py``, ``family.py``; the Llama
family's is ``reference.py``'s), on the family's weights drawn again
from the seed, over each prompt with its served tokens.  At each served
token's position the reference's logits, with the request's repetition
penalty over every token before it (prompt included), give the request's
choice set: its top-k, then its top-p nucleus (the tokens with less than
``top_p`` of the probability ranked above them), at its temperature;
for a greedy request the best token alone.  A token's gap is by how much
its logit lies below the lowest logit of that set, 0 inside it: for a
greedy token, the gap below the reference's best.

With the mix's ``check.every_position``, the program's own prompt logits
at every position of the sampled sequences (``EngineInstance.decode``,
the same engine, pool and kernels, once the window has closed) add the
gap of the token they put first at each position, a greedy choice.

The numbers: ``max_gap``, the widest gap of every choice read;
``mean_gap`` and ``mean_sq_gap``, the mean of the gaps and of their
squares over every choice read; ``served_max_gap``, the widest over the
served tokens alone.  The cell's ``portbench/limits/<workload>.json`` names the
numbers compared and gives each its limit.  The reference computes in
the precision the cell's configuration states: with the mix's
``check.reference_kv`` set to ``pool``, K and V pass through the pool's
int8 qparams as the program's pool stores them.  The control
(``check.control``, ``run.py --control``) is the program on its own path
one precision lower, read in the same way.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import family
import reference
from serve import FINISH
from traffic import sampling_of

LIMITS = Path(__file__).resolve().parent / 'limits'
ROWS = 256          # logits rows sorted at once


def sample(records, rule: dict, seed: int) -> List:
    """The finished requests to check: the longest and the longest greedy
    one, then others in an order drawn from the seed, until
    ``min_served_tokens`` are in or ``max_requests`` are taken."""
    cands = sorted((r for r in records if r.status == FINISH and r.tokens),
                   key=lambda r: r.req.index)
    if not cands:
        return []

    def size(r):
        return (len(r.req.prompt) + len(r.tokens), -r.req.index)
    out = [max(cands, key=size)]
    greedy = [r for r in cands if r.req.greedy]
    if greedy and max(greedy, key=size) is not out[0]:
        out.append(max(greedy, key=size))
    rest = [r for r in cands if all(r is not o for o in out)]
    order = np.random.default_rng([seed % 2 ** 64, 7]).permutation(len(rest))
    served = sum(len(r.tokens) for r in out)
    for i in order:
        if len(out) >= rule['max_requests'] or \
                served >= rule['min_served_tokens']:
            break
        out.append(rest[i])
        served += len(rest[i].tokens)
    return out


def penalised(logits: torch.Tensor, history: torch.Tensor, first: int,
              penalty: float) -> torch.Tensor:
    """Rows of ``logits`` [R, V] for the tokens ``history[first + r]``,
    r < R, with the repetition penalty over each row's history before it
    (``history[:first + r]``): a seen token's positive logit divided by
    ``penalty``, its negative one multiplied."""
    if penalty == 1.0:
        return logits
    r, v = logits.shape
    dev = logits.device
    history = history.to(dev).long()
    # where each token first appears in the history (past the end: never)
    at = torch.full((v,), history.numel(), dtype=torch.long, device=dev)
    at.scatter_reduce_(0, history, torch.arange(history.numel(),
                                                device=dev), 'amin')
    seen = at[None] < (first + torch.arange(r, device=dev))[:, None]
    return torch.where(seen, torch.where(logits > 0, logits / penalty,
                                         logits * penalty), logits)


def choice_floor(logits: torch.Tensor, top_k: int, top_p: float,
                 temperature: float) -> torch.Tensor:
    """The lowest logit [R] of each row's choice set: the ``top_k`` best
    (all with ``top_k`` <= 0), then those with less than ``top_p`` of the
    probability at ``temperature`` ranked above them."""
    out = []
    for r0 in range(0, logits.shape[0], ROWS):
        vals = logits[r0:r0 + ROWS].sort(-1, descending=True).values
        if top_k > 0:
            vals = vals[:, :top_k]
        probs = (vals / temperature).softmax(-1)
        inside = (probs.cumsum(-1) - probs) < top_p
        last = inside.sum(-1).clamp(min=1) - 1
        out.append(vals.gather(-1, last[:, None])[:, 0])
    return torch.cat(out)


def _sequences(chosen, device):
    """Teacher-forced ids (prompt, then the served tokens but the last)."""
    return [torch.cat([torch.as_tensor(r.req.prompt, dtype=torch.int64),
                       torch.as_tensor(r.tokens[:-1], dtype=torch.int64)]
                      ).to(device) for r in chosen]


def compare(raw, model: dict, mix: dict, chosen, kv: Optional[dict] = None,
            program_argmax: Optional[Sequence] = None,
            forward=None) -> Dict[str, float]:
    """The gaps of the served tokens of ``chosen`` (records) and, with
    ``program_argmax`` (per record, the program's first token at each
    position of its sequence), of the program's choice at every
    position.  ``kv``: the stated pool's qparams for the reference;
    ``forward``: the family's reference (the Llama family's by
    default)."""
    forward = forward or family.load(family.DEFAULT).forward
    dev = raw['embed'].device
    seqs = _sequences(chosen, dev)
    every = program_argmax is not None
    want = [torch.arange(len(s), device=dev) if every else
            torch.arange(len(r.req.prompt) - 1, len(s), device=dev)
            for s, r in zip(seqs, chosen)]
    stats: dict = {}
    logits = forward(raw, model, seqs, want, kv=kv, stats=stats)
    served_gaps, all_gaps, sizes, floors_n = [], [], [], 0
    for i, (lg, r) in enumerate(zip(logits, chosen)):
        n = len(r.req.prompt)
        sp = sampling_of(r.req, mix)
        at = n - 1 if every else 0           # row of the first served token
        hist = torch.cat([torch.as_tensor(r.req.prompt, dtype=torch.int64),
                          torch.as_tensor(r.tokens, dtype=torch.int64)])
        rows = penalised(lg[at:at + len(r.tokens)], hist, n,
                         float(sp['repetition_penalty']))
        floor = choice_floor(rows, int(sp['top_k']), float(sp['top_p']),
                             float(sp['temperature']))
        toks = torch.as_tensor(r.tokens, device=dev)
        g = (floor - rows.gather(-1, toks[:, None])[:, 0]).clamp(min=0)
        served_gaps.append(g)
        sizes.append((rows >= floor[:, None]).sum(-1))
        floors_n += len(r.tokens)
        if every:
            am = torch.as_tensor(np.asarray(program_argmax[i]),
                                 device=dev).long()
            all_gaps.append(reference.gaps(lg, am))
        logits[i] = None
    served = torch.cat(served_gaps)
    gaps = torch.cat(served_gaps + all_gaps)
    out: Dict[str, float] = {
        'max_gap': float(gaps.max()), 'mean_gap': float(gaps.mean()),
        'mean_sq_gap': float(gaps.square().mean()),
        'served_max_gap': float(served.max()),
        'served_tokens': float(floors_n), 'choices': float(gaps.numel()),
        'choice_set_median': float(torch.cat(sizes).float().median()),
        'requests': float(len(chosen))}
    if 'kv_clipped_share' in stats:
        out['kv_clipped_share'] = stats['kv_clipped_share']
    return out


def limits(workload: str, where: Path = LIMITS) -> Dict[str, dict]:
    """The cell's limits file, or nothing before its limits are set."""
    path = Path(where) / f'{workload}.json'
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def judge(numbers: Dict[str, float], lim: Dict[str, dict]) -> Dict[str, dict]:
    """Each compared number (a key of the limits file) beside its
    limit."""
    return {k: {'value': numbers.get(k), 'limit': v.get('limit')}
            for k, v in lim.items()}


def passed(judged: Dict[str, dict]) -> bool:
    return bool(judged) and all(
        v['value'] is not None and v['limit'] is not None
        and v['value'] <= v['limit'] for v in judged.values())


__all__ = ['sample', 'penalised', 'choice_floor', 'compare', 'limits',
           'judge', 'passed']
