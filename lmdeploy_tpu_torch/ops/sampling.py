"""Batched sampling pipeline — port of ``lmdeploy_tpu/ops/sampling.py``.

ban words -> min-length EOS mask -> repetition / presence / frequency
penalties -> temperature -> top-k -> top-p -> min-p -> a draw, over fixed
[B] batch slots with every parameter a per-slot tensor (a disabled
feature is the identity: k = 0, p = 1, penalty 1).  Per-slot randomness is
a threefry key held as data (``ops/prng.py``), split on every step in
every mode, so greedy and sampled turns interleave reproducibly and a key
can be saved at the exact sub-step a slot stopped.

The three modes of :func:`sample_step` are chosen by the host, which
knows every running slot's GenerationConfig:

- ``'greedy'``: one argmax (every running slot has top_k == 1);
- ``'candidates'``: the exact top-1024 candidates, sorted (the TPU's
  ``approx_max_k`` is not ported);
- ``'full'``: the whole vocabulary sorted, for slots with top_k <= 0.

The ban-words and penalty passes scatter over the full vocabulary, so
they run only when some slot enables them, as the JAX ``lax.cond``s do.
The JAX package decides that on the device; here the host passes the
decision (``passes``), since a device-side test would stop the host until
the device catches up.  Both passes are the identity on a slot that does
not enable them, so the decision never changes a result.
The full-vocabulary oracles ``top_k_mask`` / ``top_p_mask`` /
``min_p_mask`` are test references of the JAX package and are not ported.

:func:`sample_step` names its parts for the profiler
(``utils/profiler.py::span``): ``sampling.penalties`` (ban words, the
min-length EOS mask, the penalties), ``sampling.filter`` (temperature, the
candidates' sort, top-k / top-p / min-p) and ``sampling.prng`` (the key
split and the draw).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiler import span
from . import prng

NEG_INF = -1e30
MAX_TOPK = 1024  # reference clips top_k to 1024 likewise
MAX_STOP_BAD_WORDS = 32  # reference kMaxStopBadWordsLen (gpt_kernels.h)


@dataclasses.dataclass
class SamplingState:
    """Per-slot sampling parameters and RNG keys (all leading dim [B])."""
    top_k: torch.Tensor              # int32; 0 disables
    top_p: torch.Tensor              # f32; 1.0 disables
    min_p: torch.Tensor              # f32; 0.0 disables
    temperature: torch.Tensor        # f32
    repetition_penalty: torch.Tensor  # f32; 1.0 disables
    presence_penalty: torch.Tensor   # f32; 0.0 disables
    frequency_penalty: torch.Tensor  # f32; 0.0 disables
    rng_key: torch.Tensor            # int32 [B, 2]: threefry key words
    bad_words: torch.Tensor          # int32 [B, MAX_BAD]; pad -1
    stop_words: torch.Tensor         # int32 [B, MAX_STOP]; pad -1
    eos_id: torch.Tensor             # int32
    ignore_eos: torch.Tensor         # bool
    min_new_tokens: torch.Tensor     # int32
    max_new_tokens: torch.Tensor     # int32

    @staticmethod
    def init(batch: int, device='cuda', eos_id: int = 2,
             max_words: int = MAX_STOP_BAD_WORDS) -> 'SamplingState':
        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype, device=device)
        i32, f32 = torch.int32, torch.float32
        return SamplingState(
            top_k=full((batch,), 0, i32),
            top_p=full((batch,), 1.0, f32),
            min_p=full((batch,), 0.0, f32),
            temperature=full((batch,), 1.0, f32),
            repetition_penalty=full((batch,), 1.0, f32),
            presence_penalty=full((batch,), 0.0, f32),
            frequency_penalty=full((batch,), 0.0, f32),
            rng_key=full((batch, 2), 0, i32),
            bad_words=full((batch, max_words), -1, i32),
            stop_words=full((batch, max_words), -1, i32),
            eos_id=full((batch,), eos_id, i32),
            ignore_eos=full((batch,), False, torch.bool),
            min_new_tokens=full((batch,), 0, i32),
            max_new_tokens=full((batch,), 512, i32))


def full_vocab_passes(state: SamplingState) -> Tuple[bool, bool]:
    """(ban words, penalties): whether any slot of ``state`` enables each
    full-vocabulary pass.  Reads the device; the engine passes the same
    decision from the running requests' configs instead."""
    ban = bool(torch.any(state.bad_words >= 0))
    pen = bool(torch.any(state.repetition_penalty != 1.0)
               | torch.any(state.presence_penalty != 0.0)
               | torch.any(state.frequency_penalty != 0.0))
    return ban, pen


def _scatter_dropping(shape_bv, idx: torch.Tensor, src: torch.Tensor,
                      reduce_add: bool = False) -> torch.Tensor:
    """A [B, V] tensor of zeros with ``src`` scattered (or added) at
    columns ``idx``, where column V (one past the end) is dropped — the
    JAX scatter's ``mode='drop'``."""
    b, v = shape_bv
    out = torch.zeros((b, v + 1), dtype=src.dtype, device=src.device)
    if reduce_add:
        out.scatter_add_(1, idx.long(), src)
    else:
        out.scatter_(1, idx.long(), src)
    return out[:, :v]


def apply_repetition_penalty(logits, history, history_len, penalty,
                             presence=None, frequency=None, gen_start=None):
    """Divide positive / multiply negative logits of previously seen tokens
    (over the full history, prompt included); ``presence`` / ``frequency``
    subtract a flat / per-count amount from each token seen among the
    GENERATED tokens (from ``gen_start``; None counts everything).

    logits f32 [B, V]; history int [B, S]; history_len / gen_start int
    [B]; penalty / presence / frequency f32 [B]."""
    b, v = logits.shape
    pos = torch.arange(history.shape[1], device=logits.device)[None]
    valid = pos < history_len[:, None]
    idx = torch.where(valid, history.long(), v)
    seen = _scatter_dropping((b, v), idx, valid.to(torch.int8)) > 0
    pen = penalty[:, None]
    out = torch.where(seen & (pen != 1.0),
                      torch.where(logits > 0, logits / pen, logits * pen),
                      logits)
    if presence is not None or frequency is not None:
        gen_valid = valid if gen_start is None \
            else valid & (pos >= gen_start[:, None])
        gen_idx = torch.where(gen_valid, history.long(), v)
        counts = _scatter_dropping((b, v), gen_idx,
                                   gen_valid.to(torch.float32),
                                   reduce_add=True)
        sub = torch.zeros((b, 1), dtype=torch.float32, device=logits.device)
        if presence is not None:
            sub = sub + presence[:, None] * (counts > 0)
        if frequency is not None:
            sub = sub + frequency[:, None] * counts
        out = out - sub
    return out


def ban_words(logits, word_ids):
    """Set banned token ids to NEG_INF.  word_ids int [B, W], -1 padded."""
    v = logits.shape[1]
    ok = word_ids >= 0
    idx = torch.where(ok, word_ids.long(), v)
    banned = _scatter_dropping(logits.shape, idx, ok.to(torch.int8)) > 0
    return logits.masked_fill(banned, NEG_INF)


def mask_eos_below_min_len(logits, eos_id, generated, min_new_tokens):
    """Forbid EOS until ``min_new_tokens`` have been generated."""
    cols = torch.arange(logits.shape[1], device=logits.device)[None]
    block = (generated < min_new_tokens)[:, None] \
        & (cols == eos_id.long()[:, None])
    return logits.masked_fill(block, NEG_INF)


def report_temperature(t):
    """Reporting basis for the top-N logprob planes: an effectively-greedy
    slot (temperature < 1e-3) reports at temperature 1.0, the model's own
    distribution.  Sampling never uses this basis."""
    return torch.where(t < 1e-3, torch.ones_like(t), torch.clamp(t, min=1e-3))


def greedy_tops(logits, temperature, topn: int):
    """The top-N planes of greedy rows: (ids int32 [R, topn], logprobs
    [R, topn]) over the whole vocabulary on the report basis; logits
    [R, V], temperature [R]."""
    tv = logits / report_temperature(temperature)[:, None]
    top_vals, top_ids = torch.topk(tv, topn, dim=-1)
    return (top_ids.to(torch.int32),
            top_vals - torch.logsumexp(tv, dim=-1, keepdim=True))


def filter_candidates(vals, top_k, top_p, min_p):
    """The top-k -> top-p -> min-p cascade on desc-sorted candidate logits
    ``vals`` [R, C] with per-row parameters [R] (shared by sample_step and
    the speculative verify)."""
    c = vals.shape[-1]
    pos = torch.arange(c, device=vals.device)[None]
    kk = torch.where(top_k <= 0, c, torch.clamp(top_k, 1, c))[:, None]
    vals = torch.where(pos < kk, vals, NEG_INF)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    inside = (cum - probs) < top_p[:, None]     # keeps >= 1 token
    vals = torch.where(inside, vals, NEG_INF)
    cutoff = probs[:, :1] * min_p[:, None]      # max prob is first
    return torch.where((probs >= cutoff) | (min_p[:, None] <= 0.0),
                       vals, NEG_INF)


def candidates(lg: torch.Tensor, mode: str):
    """Desc-sorted (values, indices) of each row of ``lg`` [R, V]: the top
    MAX_TOPK in 'candidates' mode, the whole row in 'full' mode.  Ties
    keep index order, as in ``jax.lax.top_k`` (``torch.topk`` does not
    promise an order among ties)."""
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    if mode == 'candidates':
        return vals[:, :MAX_TOPK], idx[:, :MAX_TOPK]
    return vals, idx


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def sample_step(logits, state: SamplingState, history, history_len,
                generated, mode: str = 'candidates', topn: int = 0,
                passes: Optional[Tuple[bool, bool]] = None):
    """One sampling step over [B, V] logits (``lmdeploy_tpu`` semantics).

    history int [B, S] (prompt + generated), history_len / generated int
    [B]; ``mode`` 'greedy' / 'candidates' / 'full' as the module says;
    ``topn`` > 0 also returns the top-``topn`` alternatives and their
    logprobs, from the temperature-scaled distribution BEFORE the
    top-k/top-p/min-p cut (report basis: :func:`report_temperature`), and
    then the token logprob is taken from that same distribution so it
    equals the token's own entry; ``passes``: the host's decision for the
    full-vocabulary passes (None: read it from ``state``).

    Returns (tokens int32 [B], new rng_key int32 [B, 2], token logprob f32
    [B]) and, with ``topn`` > 0, (top ids int32 [B, topn], top logprobs
    f32 [B, topn])."""
    ban, pen = full_vocab_passes(state) if passes is None else passes
    with span('sampling.penalties'):
        logits = logits.float()
        if ban:
            logits = ban_words(logits, state.bad_words)
        logits = mask_eos_below_min_len(logits, state.eos_id, generated,
                                        state.min_new_tokens)
        if pen:
            logits = apply_repetition_penalty(
                logits, history, history_len, state.repetition_penalty,
                state.presence_penalty, state.frequency_penalty,
                gen_start=history_len - generated)
    with span('sampling.prng'):
        split = prng.split(state.rng_key)             # [B, 2, 2]
    new_keys, sample_keys = split[:, 0], split[:, 1]
    if mode == 'greedy':
        # temperature / top-p / min-p cannot change an argmax; the
        # post-filter candidate set is {argmax}, so the logprob is 0
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        if topn > 0:
            tops = greedy_tops(logits, state.temperature, topn)
            return tokens, new_keys, tops[1][:, 0], tops
        return tokens, new_keys, torch.zeros_like(logits[:, 0])
    if mode not in ('candidates', 'full'):
        raise ValueError(f'unknown sampling mode {mode!r}')
    with span('sampling.filter'):
        lg = logits / torch.clamp(state.temperature, min=1e-5)[:, None]
        pre_vals, idx = candidates(lg, mode)
        vals = filter_candidates(pre_vals, state.top_k, state.top_p,
                                 state.min_p)
    with span('sampling.prng'):
        tok_c = prng.categorical(sample_keys, vals)   # [B] candidate index
    tokens = _take(idx, tok_c).to(torch.int32)
    if topn > 0:
        f = (torch.clamp(state.temperature, min=1e-5)
             / report_temperature(state.temperature))[:, None]
        pre_lps = torch.log_softmax(pre_vals * f, dim=-1)
        return (tokens, new_keys, _take(pre_lps, tok_c),
                (idx[:, :topn].to(torch.int32), pre_lps[:, :topn]))
    return tokens, new_keys, _take(torch.log_softmax(vals, dim=-1), tok_c)


def check_stop(tokens: torch.Tensor, state: SamplingState,
               generated: torch.Tensor) -> torch.Tensor:
    """Per-slot finished flags after sampling ``tokens`` (EOS unless
    ignored, a single-token stop word, or the length limit);
    ``generated`` already counts the new token."""
    is_eos = (tokens == state.eos_id) & ~state.ignore_eos
    is_stop = torch.any(tokens[:, None] == state.stop_words, dim=1)
    too_long = generated >= state.max_new_tokens
    return is_eos | is_stop | too_long


def make_rng_keys(seeds) -> torch.Tensor:
    """Per-slot key words (int32 [B, 2]) from integer seeds (host side)."""
    return torch.from_numpy(np.stack([prng.key_from_seed(s) for s in seeds])
                            .view(np.int32))


__all__ = ['SamplingState', 'sample_step', 'check_stop', 'make_rng_keys',
           'apply_repetition_penalty', 'ban_words', 'filter_candidates',
           'mask_eos_below_min_len', 'report_temperature', 'greedy_tops',
           'candidates', 'full_vocab_passes', 'NEG_INF', 'MAX_TOPK',
           'MAX_STOP_BAD_WORDS']
