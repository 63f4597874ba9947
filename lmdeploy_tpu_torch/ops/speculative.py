"""Speculative decoding building blocks — prompt-lookup (n-gram) drafts and
their exact verification.  Port of ``lmdeploy_tpu/ops/speculative.py``.

The draft is looked up on the device in the slot's own token history (no
host round trip), and the verify reuses the model forward over [B, K+1]
positions: bs1 decode is bound by weight bytes, so verifying K+1 positions
costs little more than generating one token, and accepted drafts multiply
the tokens per forward.

Not ported: the JAX package's ``LMDEPLOY_TPU_NGRAM_DOT`` one-hot gather and
``greedy_argmax`` (max + iota) are TPU workarounds; the port gathers with
``torch.gather`` and takes ``torch.argmax``, whose ties go to the first
maximum like ``jnp.argmax``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import prng
from .sampling import (NEG_INF, SamplingState, apply_repetition_penalty,
                       ban_words, candidates, filter_candidates,
                       full_vocab_passes, mask_eos_below_min_len,
                       report_temperature)


def repeat_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """Each row of ``a`` n times in a row ([B, ...] -> [B*n, ...]), like
    ``repeat_interleave`` without its device-to-host read of the size."""
    return a.unsqueeze(1).expand(a.shape[0], n, *a.shape[1:]) \
        .reshape(-1, *a.shape[1:])


def _ngram_match_pos(history, history_len, ngram: int):
    """Most recent position whose preceding ``ngram`` tokens equal the
    current suffix; -1 where none.  Returns int64 [B]."""
    b, s = history.shape
    pos = torch.arange(s, device=history.device)[None]
    # suffix[b, t] = history[b, hl - ngram + t]
    suf_idx = history_len.long()[:, None] - ngram \
        + torch.arange(ngram, device=history.device)[None]
    suffix = torch.gather(history, 1, torch.clamp(suf_idx, min=0))
    # match[b, j]: history[b, j-ngram : j] == suffix (candidate start j)
    match = torch.ones((b, s), dtype=torch.bool, device=history.device)
    for t in range(ngram):
        shifted = F.pad(history, (ngram - t, 0))[:, :s]
        match &= shifted == suffix[:, t:t + 1]
    # j starts strictly before the continuation point and leaves the
    # suffix itself out; pos >= ngram also kills the zero-padded columns
    match &= (pos < history_len[:, None] - 1) & (pos >= ngram)
    long_enough = history_len >= ngram + 1
    j = torch.amax(torch.where(match, pos, -1), dim=1)
    return torch.where(long_enough, j, -1)


def ngram_propose(history: torch.Tensor, history_len: torch.Tensor, k: int,
                  ngram: int = 3, ngram_min: int = 0) -> torch.Tensor:
    """Propose ``k`` draft tokens per slot by prompt lookup: the tokens
    that followed the most recent earlier occurrence of the current
    suffix.  With ``ngram_min`` < ``ngram`` the lookup cascades longest
    match first, down to ``ngram_min``-token suffixes.

    history int32 [B, S] (history[:, :history_len] valid, ending with the
    current last token); history_len int [B].  Returns int32 [B, k], zeros
    where there is no match (such drafts are simply rejected)."""
    s = history.shape[1]
    lo = ngram_min if ngram_min and ngram_min < ngram else ngram
    j = torch.full(history_len.shape, -1, dtype=torch.int64,
                   device=history.device)
    for n in range(ngram, lo - 1, -1):     # longest match wins
        j = torch.where(j >= 0, j, _ngram_match_pos(history, history_len, n))
    has = j >= 0
    steps = torch.arange(k, device=history.device)[None]
    at = torch.clamp(j, min=0)[:, None] + steps                  # [B, k]
    draft = torch.gather(history, 1, torch.clamp(at, max=s - 1))
    # tokens at/after history_len are stale: zero them
    ok = has[:, None] & (at < history_len[:, None])
    return torch.where(ok, draft, 0).to(torch.int32)


def spec_verify_sample(logits: torch.Tensor, draft: torch.Tensor,
                       smp: SamplingState, history: torch.Tensor,
                       history_len: torch.Tensor, generated: torch.Tensor,
                       sample_keys: torch.Tensor, mode: str = 'candidates',
                       topn: int = 0,
                       passes: Optional[Tuple[bool, bool]] = None):
    """Exact rejection-sampling verification of deterministic drafts.

    A prompt-lookup draft is a point mass, so the speculative-sampling rule
    collapses to: accept d_i with probability p_i(d_i); on rejection draw
    from p_i with d_i masked out.  The emitted marginal at every position
    is then exactly p_i, the distribution the plain path's sample_step
    draws from (bad words, min-length EOS, penalties whose seen-set holds
    the accepted draft prefix, temperature, top-k/top-p/min-p).  A top_k
    == 1 slot degenerates to the greedy match-or-correct rule.

    logits f32 [B, K+1, V] (vocab padding masked); draft int [B, K];
    history / history_len as the decode state; generated int [B] tokens
    generated before this round; sample_keys int32 [B, 2], the keys this
    round's draws consume; ``mode`` 'candidates' or 'full'; ``topn`` and
    ``passes`` as in :func:`ops.sampling.sample_step`.

    Returns (g int32 [B, K+1], accept bool [B, K], logp f32 [B, K+1]) and,
    with ``topn`` > 0, (top ids int32 [B, K+1, topn], top logprobs f32
    [B, K+1, topn]).  g[:, i] is the draft where accepted, else the
    resample; g[:, K] is the bonus draw; logp is log p_i(g_i), or with
    ``topn`` its log-probability before the filters."""
    b, kp1, v = logits.shape
    k = kp1 - 1
    dev = logits.device
    ban, pen = full_vocab_passes(smp) if passes is None else passes

    def rep(a):  # per-slot rows -> per-(slot, position) rows
        return repeat_rows(a, kp1)

    lgf = logits.float().reshape(b * kp1, v)
    if ban:
        lgf = ban_words(lgf, rep(smp.bad_words))
    t_idx = torch.arange(kp1, device=dev)[None]
    lgf = mask_eos_below_min_len(lgf, rep(smp.eos_id),
                                 (generated[:, None] + t_idx).reshape(-1),
                                 rep(smp.min_new_tokens))
    if pen:
        # the drafts go in at history_len.. so position i's window (iota <
        # history_len + i) covers exactly draft[:i]; positions past the
        # row drop, as the JAX scatter's mode='drop'
        s = history.shape[1]
        d_pos = history_len.long()[:, None] \
            + torch.arange(k, device=dev)[None]
        hist_ext = F.pad(history, (0, k)).scatter(1, d_pos,
                                                  draft.to(history.dtype))
        lgf = apply_repetition_penalty(
            lgf, rep(hist_ext[:, :s]),
            (history_len[:, None] + t_idx).reshape(-1),
            rep(smp.repetition_penalty), rep(smp.presence_penalty),
            rep(smp.frequency_penalty),
            # presence/frequency count generated tokens only; draft
            # positions extend history and generated in lockstep
            gen_start=rep(history_len - generated))
    lgf = lgf / torch.clamp(rep(smp.temperature), min=1e-5)[:, None]
    pre_vals, idx = candidates(lgf, mode)
    vals = filter_candidates(pre_vals, rep(smp.top_k), rep(smp.top_p),
                             rep(smp.min_p))
    c = vals.shape[-1]
    vals3 = vals.reshape(b, kp1, c)
    idx3 = idx.reshape(b, kp1, c)
    probs_f = torch.softmax(vals3, dim=-1)                    # final p_i
    is_draft = idx3[:, :k] == draft[:, :, None].long()        # [B, K, C]
    p_draft = torch.sum(torch.where(is_draft, probs_f[:, :k], 0.0), dim=-1)

    ks = prng.split(sample_keys)                              # [B, 2, 2]
    accept = prng.uniform(ks[:, 0], (k,)) < p_draft           # [B, K]
    # residual rows: the draft masked for i < K, the bonus row unmasked;
    # a row that masking empties (top_k == 1 and draft == argmax) keeps
    # its unmasked values (its rejection has probability <= float eps)
    mask_d = torch.cat([is_draft, torch.zeros_like(is_draft[:, :1])], 1)
    vals_rs = torch.where(mask_d, NEG_INF, vals3)
    empty = torch.all(vals_rs <= NEG_INF, dim=-1, keepdim=True)
    vals_rs = torch.where(empty, vals3, vals_rs)
    tok_c = prng.categorical(ks[:, 1], vals_rs)               # [B, K+1]
    samp = torch.gather(idx3, -1, tok_c[..., None])[..., 0]
    g = torch.cat([torch.where(accept, draft.long(), samp[:, :k]),
                   samp[:, k:]], dim=1)
    hit = idx3 == g[..., None]
    if topn > 0:
        f = (torch.clamp(rep(smp.temperature), min=1e-5)
             / report_temperature(rep(smp.temperature)))[:, None]
        pre_lps = torch.log_softmax(pre_vals * f, dim=-1)
        top_ids = idx[:, :topn].reshape(b, kp1, topn).to(torch.int32)
        top_lps = pre_lps[:, :topn].reshape(b, kp1, topn)
        # every emittable g is a candidate, so the masked sum is exact
        logp = torch.sum(torch.where(hit, pre_lps.reshape(b, kp1, c), 0.0),
                         dim=-1)
        return g.to(torch.int32), accept, logp, (top_ids, top_lps)
    p_g = torch.sum(torch.where(hit, probs_f, 0.0), dim=-1)
    return (g.to(torch.int32), accept,
            torch.log(torch.clamp(p_g, min=1e-30)))


__all__ = ['ngram_propose', 'spec_verify_sample', 'repeat_rows']
