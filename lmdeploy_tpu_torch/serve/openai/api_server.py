"""OpenAI-compatible HTTP server.

Port of ``lmdeploy_tpu/serve/openai/api_server.py`` (reference:
lmdeploy/serve/openai/api_server.py: /v1/models:41,
/v1/chat/completions:75, /v1/embeddings:230, /generate:253; session id
derived from the client host), in two parts:

- a transport-free core: one async function per route, taking the
  :class:`AsyncEngine`, the parsed JSON body, the client's host and the
  request headers, and returning ``(status, payload)``.  The payload is a
  dict (a JSON body), a str (``/metrics``' text) or an async iterator of
  str chunks (a streamed body: SSE ``data:`` frames, or JSON lines for
  ``/generate``).  :data:`ROUTES` maps each (method, path) to its function.
  The core imports neither aiohttp nor pydantic, so it runs wherever the
  engine does.
- :func:`build_app` and :func:`main`: a thin aiohttp adapter over the
  core; aiohttp is imported inside them only.

    python -m lmdeploy_tpu_torch.serve.openai.api_server <workspace> \
        --device cuda
"""
from __future__ import annotations

import asyncio
import hashlib
import math
from http import HTTPStatus
from typing import Any, AsyncIterator, Callable, Dict, Mapping, Optional, \
    Tuple

import numpy as np

from ..async_engine import AsyncEngine
from .protocol import (ChatCompletionRequest, ChatCompletionResponse,
                       ChatCompletionResponseChoice,
                       ChatCompletionResponseStreamChoice,
                       ChatCompletionStreamResponse, ChatMessage,
                       CompletionRequest, CompletionResponse,
                       CompletionResponseChoice,
                       CompletionResponseStreamChoice,
                       CompletionStreamResponse, DeltaMessage,
                       EmbeddingsRequest, EmbeddingsResponse,
                       ErrorResponse, GenerateRequest, GenerateResponse,
                       ModelCard, ModelList, ModelPermission, UsageInfo,
                       ValidationError)

Reply = Tuple[int, Any]   # (HTTP status, dict | str | AsyncIterator[str])

# engine readback planes cap at 5 alternatives (OpenAI allows up to 20;
# values above clip, negatives floor to 0)
MAX_TOP_LOGPROBS = 5


def _model_name(engine: AsyncEngine) -> str:
    return engine.engine.cfg.model_name


def error(status: HTTPStatus, message: str) -> Reply:
    return status.value, ErrorResponse(message=message,
                                       code=status.value).model_dump()


def session_id(remote: Optional[str], headers: Mapping[str, str]) -> int:
    """Session id from the client host and its ``X-Session-Id`` header
    (reference: api_server.py ip2id).  md5, not hash(): Python's hash()
    is salted per process, so ids would change across server restarts
    and break interactive continuations."""
    extra = next((v for k, v in (headers or {}).items()
                  if k.lower() == 'x-session-id'), '')
    host = (remote or '127.0.0.1') + str(extra)
    digest = hashlib.md5(host.encode()).digest()
    return int.from_bytes(digest[:4], 'big') % (2 ** 30)


def _overloaded(engine: AsyncEngine) -> Optional[Reply]:
    """Backpressure: engine queue saturation is HTTP 429."""
    if engine.engine.overloaded():
        return error(HTTPStatus.TOO_MANY_REQUESTS,
                     'server is overloaded, retry later')
    return None


def _check_model(engine: AsyncEngine, model: str) -> Optional[Reply]:
    if model != _model_name(engine):
        return error(HTTPStatus.NOT_FOUND,
                     f'The model `{model}` does not exist.')
    return None


def _parse(model, body) -> Tuple[Any, Optional[Reply]]:
    try:
        return model.from_dict(body), None
    except ValidationError as e:
        return None, error(HTTPStatus.BAD_REQUEST, str(e))


def _sse(obj) -> str:
    return f'data: {obj.model_dump_json()}\n\n'


def _finish(reason):
    return None if reason == 'cancel' else reason


async def available_models(engine: AsyncEngine, body=None, remote=None,
                           headers=None) -> Reply:
    """GET /v1/models."""
    name = _model_name(engine)
    cards = [ModelCard(id=name, root=name, permission=[ModelPermission()])]
    return 200, ModelList(data=cards).model_dump()


async def chat_completions_v1(engine: AsyncEngine, body, remote=None,
                              headers=None) -> Reply:
    """POST /v1/chat/completions — streaming SSE or full JSON."""
    req, err = _parse(ChatCompletionRequest, body)
    err = err or _check_model(engine, req.model) or _overloaded(engine)
    if err:
        return err
    sid = session_id(remote, headers)
    # `stop`: bool interrupts the session (lmdeploy extension); a string
    # or list is the OpenAI stop-strings contract
    stop_flag = req.stop if isinstance(req.stop, bool) else False
    stop_strings = None if isinstance(req.stop, bool) else req.stop
    want_lp = bool(req.logprobs)
    n_top = max(0, min(int(req.top_logprobs or 0), MAX_TOP_LOGPROBS)) \
        if want_lp else 0
    gen = engine.generate_openai(
        req.messages, sid, stream_response=bool(req.stream),
        renew_session=bool(req.renew_session),
        request_output_len=req.max_tokens or 512, stop=stop_flag,
        top_p=req.top_p, top_k=req.top_k if req.top_k is not None else 40,
        temperature=req.temperature,
        repetition_penalty=req.repetition_penalty,
        presence_penalty=req.presence_penalty or 0.0,
        frequency_penalty=req.frequency_penalty or 0.0,
        ignore_eos=bool(req.ignore_eos), stop_strings=stop_strings,
        output_logprobs=want_lp, top_logprobs=n_top)
    tok = engine.tokenizer

    def lp_content(out):
        """OpenAI chat logprobs entries for one GenOut frame."""
        entries = []
        for i, tid in enumerate(out.token_ids or []):
            piece = tok.decode([int(tid)])
            lp = (out.logprobs[i] if out.logprobs
                  and i < len(out.logprobs) else None)
            entry = {'token': piece, 'logprob': lp,
                     'bytes': list(piece.encode('utf-8'))}
            if n_top:
                tops = (out.top_logprobs[i] if out.top_logprobs
                        and i < len(out.top_logprobs) else {})
                entry['top_logprobs'] = [
                    {'token': tok.decode([int(t)]), 'logprob': float(v),
                     'bytes': list(tok.decode([int(t)]).encode('utf-8'))}
                    for t, v in sorted(tops.items(),
                                       key=lambda kv: -kv[1])]
            entries.append(entry)
        return entries

    if req.stream:
        async def stream() -> AsyncIterator[str]:
            yield _sse(ChatCompletionStreamResponse(
                model=req.model,
                choices=[ChatCompletionResponseStreamChoice(
                    index=0, delta=DeltaMessage(role='assistant'))]))
            async for out in gen:
                yield _sse(ChatCompletionStreamResponse(
                    model=req.model,
                    choices=[ChatCompletionResponseStreamChoice(
                        index=0, delta=DeltaMessage(content=out.response),
                        logprobs=({'content': lp_content(out)}
                                  if want_lp and out.token_ids else None),
                        finish_reason=_finish(out.finish_reason))]))
            yield 'data: [DONE]\n\n'
        return 200, stream()

    text, tokens, input_len, finish, content = '', 0, 0, None, []
    async for out in gen:
        text += out.response
        tokens = out.generate_token_len
        input_len = out.input_token_len
        finish = out.finish_reason
        if want_lp and out.token_ids:
            content.extend(lp_content(out))
    return 200, ChatCompletionResponse(
        model=req.model,
        choices=[ChatCompletionResponseChoice(
            index=0, message=ChatMessage(role='assistant', content=text),
            logprobs={'content': content} if want_lp else None,
            finish_reason=_finish(finish))],
        usage=UsageInfo(prompt_tokens=input_len, completion_tokens=tokens,
                        total_tokens=input_len + tokens)).model_dump()


async def completions_v1(engine: AsyncEngine, body, remote=None,
                         headers=None) -> Reply:
    """POST /v1/completions — raw-prompt continuation, no chat template.
    A single prompt or a list (served one after another, ``n`` choices
    each), ``echo``, prompt scoring (``echo`` + ``logprobs`` +
    ``max_tokens=0``, the lm-eval loglikelihood pattern) and SSE
    streaming of a single prompt."""
    req, err = _parse(CompletionRequest, body)
    err = err or _check_model(engine, req.model) or _overloaded(engine)
    if err:
        return err
    base_sid = session_id(remote, headers)
    prompts = [req.prompt] if isinstance(req.prompt, str) else list(req.prompt)
    stop_flag = req.stop if isinstance(req.stop, bool) else False
    stop_strings = None if isinstance(req.stop, bool) else req.stop
    if req.suffix:
        return error(HTTPStatus.BAD_REQUEST,
                     'suffix is not supported; use the codellama '
                     'infilling chat template for fill-in-the-middle')
    n = req.n or 1
    # logprobs=0 still returns the chosen-token logprobs (OpenAI: the int
    # is the number of ALTERNATIVES per position, capped at 5)
    want_logprobs = req.logprobs is not None
    n_alts = max(0, min(int(req.logprobs or 0), MAX_TOP_LOGPROBS)) \
        if want_logprobs else 0
    tok = engine.tokenizer

    def gen(prompt: str, sid: int, stream: bool):
        return engine.generate(
            prompt, sid, stream_response=stream, sequence_start=True,
            sequence_end=True, request_output_len=req.max_tokens or 16,
            stop=stop_flag, top_p=req.top_p,
            top_k=req.top_k if req.top_k is not None else 40,
            temperature=req.temperature,
            repetition_penalty=req.repetition_penalty,
            presence_penalty=req.presence_penalty or 0.0,
            frequency_penalty=req.frequency_penalty or 0.0,
            ignore_eos=bool(req.ignore_eos), stop_strings=stop_strings,
            do_preprocess=False, output_logprobs=want_logprobs,
            top_logprobs=n_alts)

    def top_strs(d):
        """{token_id: lp} -> {token_string: lp}; ascending-lp insert
        order so the BEST logprob wins a duplicated piece key."""
        return {tok.decode([int(t)]): float(lp)
                for t, lp in sorted(d.items(), key=lambda kv: kv[1])}

    def logprobs_obj(ids, lps, text_start: int, tops=None):
        """OpenAI completions logprobs (``tops``: per-position top-N
        dicts, host-computed on prompt positions, device readback on
        generated ones)."""
        pieces, offsets, pos = [], [], text_start
        for i in range(len(ids)):
            piece = tok.decode(ids[:i + 1], offset=i)
            pieces.append(piece)
            offsets.append(pos)
            pos += len(piece)
        return {'tokens': pieces, 'token_logprobs': list(lps),
                'top_logprobs': list(tops) if tops is not None else None,
                'text_offset': offsets}

    async def prompt_logprobs(prompt: str):
        """Score the prompt through the prompt-logits path
        (``EngineInstance.decode``).  The first token has no conditional
        logprob (null, as OpenAI).  Returns (ids, chosen logprobs, top
        alternatives or None)."""
        ids = tok.encode(prompt)
        if not ids:
            return [], [], (None if not n_alts else [])
        inst = engine.engine.create_instance()
        logits = await asyncio.get_running_loop().run_in_executor(
            None, inst.decode, ids)
        lg = np.asarray(logits, np.float32)      # [len(ids), vocab]
        lps, tops = [None], [None]
        for t in range(1, len(ids)):
            row = lg[t - 1] - lg[t - 1].max()
            logz = math.log(np.exp(row).sum())
            lps.append(float(row[ids[t]] - logz))
            if n_alts:
                cand = np.argpartition(row, -n_alts)[-n_alts:]
                # ascending insert order: when two candidates decode to
                # the same piece, the BEST logprob wins the dict key
                cand = cand[np.argsort(row[cand])]
                tops.append({tok.decode([int(c)]): float(row[c] - logz)
                             for c in cand})
            else:
                tops.append(None)
        return ids, lps, (tops if n_alts else None)

    if req.stream:
        if len(prompts) != 1 or n != 1:
            return error(HTTPStatus.BAD_REQUEST,
                         'streaming supports a single prompt with n=1')
        if req.max_tokens == 0:
            return error(HTTPStatus.BAD_REQUEST,
                         'max_tokens=0 scoring requests are non-streaming')
        head = None
        if req.echo:
            head_lp = None
            if want_logprobs:
                # scored before the stream starts, so a failure is a 400
                try:
                    e_ids, e_lps, e_tops = await prompt_logprobs(prompts[0])
                    head_lp = logprobs_obj(e_ids, e_lps, 0, e_tops)
                except RuntimeError as e:
                    return error(HTTPStatus.BAD_REQUEST, str(e))
            head = CompletionStreamResponse(
                model=req.model,
                choices=[CompletionResponseStreamChoice(
                    index=0, text=prompts[0], logprobs=head_lp)])

        async def stream() -> AsyncIterator[str]:
            text_pos = 0
            if head is not None:
                yield _sse(head)
                text_pos = len(prompts[0])
            seen_ids: list = []
            async for out in gen(prompts[0], base_sid, True):
                lp = None
                if want_logprobs and out.token_ids:
                    # decode only THIS frame's tokens, each against its
                    # prefix, as the engine's own detokenizer does
                    pieces, offsets = [], []
                    for tid in out.token_ids:
                        seen_ids.append(tid)
                        piece = tok.decode(seen_ids,
                                           offset=len(seen_ids) - 1)
                        pieces.append(piece)
                        offsets.append(text_pos)
                        text_pos += len(piece)
                    lp = {'tokens': pieces,
                          'token_logprobs': list(out.logprobs or []),
                          'top_logprobs': ([top_strs(d) for d in
                                            out.top_logprobs]
                                           if n_alts and out.top_logprobs
                                           else None),
                          'text_offset': offsets}
                yield _sse(CompletionStreamResponse(
                    model=req.model,
                    choices=[CompletionResponseStreamChoice(
                        index=0, text=out.response, logprobs=lp,
                        finish_reason=_finish(out.finish_reason))]))
            yield 'data: [DONE]\n\n'
        return 200, stream()

    choices = []
    prompt_tokens = completion_tokens = 0
    for i, prompt in enumerate(prompts):
        echo_ids, echo_lps, echo_tops = [], [], None
        if req.echo and want_logprobs:
            try:
                echo_ids, echo_lps, echo_tops = await prompt_logprobs(prompt)
            except RuntimeError as e:
                # e.g. the prompt exceeds session_len: a JSON 400, not 500
                return error(HTTPStatus.BAD_REQUEST, str(e))
        for j in range(n):
            sid = (base_sid + 7919 * (i * n + j)) % (2 ** 30)
            base = prompt if req.echo else ''
            if req.max_tokens == 0:
                # a pure scoring request: no generation at all
                if j == 0:
                    prompt_tokens += len(tok.encode(prompt))
                lp = logprobs_obj(echo_ids, echo_lps, 0, echo_tops) \
                    if want_logprobs else None
                choices.append(CompletionResponseChoice(
                    index=i * n + j, text=base, logprobs=lp,
                    finish_reason='length'))
                continue
            text, finish = '', None
            all_ids, all_lps, all_tops = [], [], []
            async for out in gen(prompt, sid, False):
                text += out.response
                if j == 0:
                    prompt_tokens += out.input_token_len
                completion_tokens += out.generate_token_len
                finish = out.finish_reason
                all_ids.extend(out.token_ids or [])
                all_lps.extend(out.logprobs or [])
                all_tops.extend(out.top_logprobs or [])
            lp = None
            if want_logprobs:
                # echo prepends the PROMPT tokens, scored through the
                # prompt-logits path; offsets are absolute in the text
                tops = None
                if n_alts:
                    gen_tops = [top_strs(d) for d in all_tops]
                    gen_tops += [None] * (len(all_ids) - len(gen_tops))
                    tops = (echo_tops or []) + gen_tops
                lp = logprobs_obj(echo_ids + all_ids, echo_lps + all_lps,
                                  0, tops)
            choices.append(CompletionResponseChoice(
                index=i * n + j, text=base + text, logprobs=lp,
                finish_reason=_finish(finish)))
    return 200, CompletionResponse(
        model=req.model, choices=choices,
        usage=UsageInfo(prompt_tokens=prompt_tokens,
                        completion_tokens=completion_tokens,
                        total_tokens=prompt_tokens + completion_tokens)
    ).model_dump()


async def create_embeddings(engine: AsyncEngine, body, remote=None,
                            headers=None) -> Reply:
    """POST /v1/embeddings — the prompt's token ids, as the reference
    returns them (api_server.py:230)."""
    req, err = _parse(EmbeddingsRequest, body)
    if err:
        return err
    inputs = req.input if isinstance(req.input, list) else [req.input]
    data, total = [], 0
    for i, text in enumerate(inputs):
        ids = await engine.get_embeddings(text)
        total += len(ids)
        data.append({'object': 'embedding', 'embedding': ids, 'index': i})
    return 200, EmbeddingsResponse(
        data=data, model=req.model or _model_name(engine),
        usage=UsageInfo(prompt_tokens=total, total_tokens=total,
                        completion_tokens=None)).model_dump()


async def generate(engine: AsyncEngine, body, remote=None,
                   headers=None) -> Reply:
    """POST /generate — the interactive (non-OpenAI) endpoint with
    explicit sequence_start / end / stop session control (reference:
    api_server.py:253); a stream is one JSON object per line."""
    req, err = _parse(GenerateRequest, body)
    err = err or _overloaded(engine)
    if err:
        return err
    sid = req.instance_id if req.instance_id >= 0 \
        else session_id(remote, headers)
    gen = engine.generate(
        req.prompt, sid, stream_response=req.stream,
        sequence_start=req.sequence_start, sequence_end=req.sequence_end,
        request_output_len=req.request_output_len, stop=req.stop,
        top_p=req.top_p, top_k=req.top_k, temperature=req.temperature,
        repetition_penalty=req.repetition_penalty,
        ignore_eos=req.ignore_eos)

    if req.stream:
        async def stream() -> AsyncIterator[str]:
            async for out in gen:
                yield GenerateResponse(
                    text=out.response, tokens=out.generate_token_len,
                    finish_reason=out.finish_reason).model_dump_json() + '\n'
        return 200, stream()

    text, tokens, finish = '', 0, None
    async for out in gen:
        text += out.response
        tokens = out.generate_token_len
        finish = out.finish_reason
    return 200, GenerateResponse(text=text, tokens=tokens,
                                 finish_reason=finish).model_dump()


# the JAX server's counters, then the port engine's request lifecycle
# and page shortfalls (engine/engine.py)
COUNTERS = {'requests', 'finished', 'canceled', 'errors', 'rejected',
            'timeout', 'generated_tokens', 'admitted', 'queue_wait_s',
            'prefilled', 'prefill_s', 'first_tokens', 'first_token_s',
            'no_free_pages', 'redecode_tokens'}


async def metrics(engine: AsyncEngine, body=None, remote=None,
                  headers=None) -> Reply:
    """GET /metrics — Prometheus text exposition of the engine's counters
    and gauges."""
    lines = []
    for k, v in sorted(engine.engine.metrics().items()):
        name = f'lmdeploy_{k}' + ('_total' if k in COUNTERS else '')
        kind = 'counter' if k in COUNTERS else 'gauge'
        lines.append(f'# TYPE {name} {kind}')
        lines.append(f'{name} {v}')
    return 200, '\n'.join(lines) + '\n'


ROUTES: Dict[Tuple[str, str], Callable] = {
    ('GET', '/v1/models'): available_models,
    ('POST', '/v1/chat/completions'): chat_completions_v1,
    ('POST', '/v1/completions'): completions_v1,
    ('POST', '/v1/embeddings'): create_embeddings,
    ('POST', '/generate'): generate,
    ('GET', '/metrics'): metrics,
}


def build_app(engine: AsyncEngine):
    """The aiohttp application: each route parses its JSON body (a body
    that is not JSON is a 400), calls the core and writes its reply."""
    from aiohttp import web

    def handler(fn):
        async def handle(request: web.Request) -> web.StreamResponse:
            try:
                body = await request.json() if request.method == 'POST' \
                    else None
            except ValueError as e:
                status, out = error(HTTPStatus.BAD_REQUEST, str(e))
            else:
                status, out = await fn(engine, body, request.remote,
                                       request.headers)
            if isinstance(out, dict):
                return web.json_response(out, status=status)
            if isinstance(out, str):
                return web.Response(text=out, content_type='text/plain',
                                    status=status)
            resp = web.StreamResponse(
                status=status, headers={'Content-Type': 'text/event-stream',
                                        'Cache-Control': 'no-cache'})
            await resp.prepare(request)
            async for chunk in out:
                await resp.write(chunk.encode())
            await resp.write_eof()
            return resp
        return handle

    app = web.Application()
    for (method, path), fn in ROUTES.items():
        app.router.add_route(method, path, handler(fn))
    return app


def main(model_path: str, server_name: str = '0.0.0.0',
         server_port: int = 23333, instance_num: int = 32, tp: int = 1,
         pp: int = 1, dp: int = 1, device='cuda', **kw):
    """Launch the server (reference: api_server.py:320) over an engine on
    ``device``; needs aiohttp."""
    from aiohttp import web
    engine = AsyncEngine(model_path, instance_num=instance_num, tp=tp,
                         pp=pp, dp=dp, device=device, **kw)
    web.run_app(build_app(engine), host=server_name, port=server_port)


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch api_server')
    ap.add_argument('model_path')
    ap.add_argument('--server-name', default='0.0.0.0')
    ap.add_argument('--server-port', '--port', type=int, default=23333)
    ap.add_argument('--instance-num', type=int, default=32)
    ap.add_argument('--tp', type=int, default=1,
                    help='tensor-parallel ranks (one process each, spawned '
                         'by the engine; a card each when there are enough, '
                         'else they share the first)')
    ap.add_argument('--pp', type=int, default=1,
                    help='pipeline stages (one process each, spawned '
                         'by the engine, layers cut evenly; decode rides '
                         'the microbatch ring)')
    ap.add_argument('--dp', type=int, default=1,
                    help='data-parallel groups: independent batches of '
                         'max_batch_size / dp slots, each with its own page '
                         'pool')
    ap.add_argument('--quant-policy', type=int, default=None,
                    choices=(0, 4, 8),
                    help='KV cache: 0 bf16, 4 int8, 8 int4 (both with the '
                         "workspace's calibrated qparams)")
    ap.add_argument('--speculative-k', type=int, default=None,
                    help='prompt-lookup speculative draft length '
                         '(0 disables)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu (plain versions)')
    return ap.parse_args(argv)


__all__ = ['ROUTES', 'session_id', 'error', 'available_models',
           'chat_completions_v1', 'completions_v1', 'create_embeddings',
           'generate', 'metrics', 'build_app', 'main', 'parse_args']

if __name__ == '__main__':
    main(**vars(parse_args()))
