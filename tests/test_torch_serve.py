"""The port's OpenAI server against the JAX package's, on the CPU.

Both servers serve one workspace of the cycling model
(``test_torch_engine.cycling_params``: every greedy or sampled choice wins
by a wide margin, so the two packages' texts must be equal) through
aiohttp's test client.  Each case sends the same requests to both apps and
compares statuses, JSON keys and values (ids and timestamps aside;
logprobs within 1% relative or 1e-3 absolute: the packages round
activations to bf16 in other places, about 0.4% of a logit).  The port's transport-free core must give the
app's bodies without aiohttp.
"""
import asyncio
import hashlib
import json
import math
import types

import pytest
import torch

pytest.importorskip('aiohttp')
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import lmdeploy_tpu.serve.openai.api_server as jserver  # noqa: E402
import lmdeploy_tpu_torch.serve.openai.api_server as tserver  # noqa: E402
from lmdeploy_tpu.serve.async_engine import AsyncEngine as JAsyncEngine  # noqa: E402,E501
from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine  # noqa: E402
from test_torch_frontdoor import cycling_workspace  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def engines(cycling_workspace):  # noqa: F811
    port = AsyncEngine(cycling_workspace, instance_num=2, device='cpu')
    ref = JAsyncEngine(cycling_workspace, instance_num=2)
    yield port, ref
    port.shutdown()
    ref.shutdown()


def _sse(text):
    """SSE body -> the JSON of each data frame ('[DONE]' kept)."""
    return [ln[len('data: '):] if ln.endswith('[DONE]')
            else json.loads(ln[len('data: '):])
            for ln in text.splitlines() if ln.startswith('data: ')]


async def _call(client, method, path, body=None, raw=None, headers=None):
    """(status, parsed body) of one request."""
    if raw is not None:
        r = await client.request(method, path, data=raw, headers={
            'Content-Type': 'application/json'})
    else:
        r = await client.request(method, path, json=body,
                                 headers=headers or {})
    text = (await r.read()).decode()
    ctype = r.headers.get('Content-Type', '')
    if 'event-stream' in ctype:
        if path == '/generate':
            return r.status, [json.loads(x) for x in text.splitlines()
                              if x.strip()]
        return r.status, _sse(text)
    if 'json' in ctype:
        return r.status, json.loads(text)
    return r.status, text


def serve(engine, build_app, requests):
    """Every (method, path, body) of ``requests`` through ``build_app``'s
    app, one after another; returns their (status, body)."""
    async def run():
        async with TestClient(TestServer(build_app(engine))) as client:
            return [await _call(client, *req) for req in requests]
    return asyncio.run(run())


def assert_same(a, b, path='$'):
    """Equal JSON values: same keys and types; ids and timestamps may
    differ; floats within 1% relative or 1e-3 absolute (logprobs).  Of
    top-N alternatives only the best must be the same token: the cycling
    model's runners-up are random and may be near-tied."""
    if path.endswith('top_logprobs') and isinstance(a, list) and a \
            and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if isinstance(x, dict) and 'token' in x:     # chat entries
                if i == 0:
                    assert_same(x, y, f'{path}[0]')
                else:
                    assert_same(x['logprob'], y['logprob'], f'{path}[{i}]')
            elif isinstance(x, dict):                    # {piece: lp}
                assert isinstance(y, dict) and len(x) == len(y)
                assert max(x, key=x.get) == max(y, key=y.get), (path, x, y)
                assert_same(sorted(x.values()), sorted(y.values()),
                            f'{path}[{i}]')
            else:
                assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            if k in ('id', 'created') or (k == 'message' and 'code' in a):
                assert type(a[k]) is type(b[k]), (path, k)
                continue
            assert_same(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{path}[{i}]')
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), (path, a, b)
        assert math.isclose(a, b, rel_tol=1e-2, abs_tol=1e-3), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def stream_text(frames, key):
    """The concatenated text of a stream's frames (``key`` picks it from
    a choice) and the frames' key sets."""
    chunks = [f for f in frames if isinstance(f, dict)]
    return (''.join(key(c['choices'][0]) or '' for c in chunks),
            {tuple(c) for c in chunks}, frames[-1])


def both(engines, requests):
    port, ref = engines
    got = serve(port, tserver.build_app, requests)
    want = serve(ref, jserver.build_app, requests)
    return got, want


CHAT = {'model': 'llama', 'messages': 'ab%', 'max_tokens': 6,
        'ignore_eos': True}


def test_api_server_endpoints_match_jax(engines):
    """tests/test_serve.py::test_api_server_endpoints through both apps:
    /v1/models, chat (non-stream, stream, logprobs with top_logprobs 3,
    a wrong model), embeddings, /generate (and its stream, and a second
    turn on one session), /metrics."""
    reqs = [('GET', '/v1/models'),
            ('POST', '/v1/chat/completions', dict(CHAT, renew_session=True)),
            ('POST', '/v1/chat/completions',
             dict(CHAT, stream=True, renew_session=True)),
            ('POST', '/v1/chat/completions', dict(CHAT, model='nope')),
            ('POST', '/v1/chat/completions',
             dict(CHAT, logprobs=True, top_logprobs=3, renew_session=True)),
            ('POST', '/v1/embeddings', {'input': 'abc'}),
            ('POST', '/v1/embeddings', {'input': ['ab', 'cde'],
                                        'model': 'llama'}),
            ('POST', '/generate', {'prompt': 'once upon%', 'instance_id': 99,
                                   'request_output_len': 4,
                                   'ignore_eos': True}),
            ('POST', '/generate', {'prompt': 'more%', 'instance_id': 99,
                                   'sequence_start': False,
                                   'request_output_len': 4,
                                   'ignore_eos': True, 'top_k': 1,
                                   'sequence_end': True}),
            ('POST', '/generate', {'prompt': 'zap', 'instance_id': 98,
                                   'stream': True, 'request_output_len': 4,
                                   'ignore_eos': True, 'sequence_end': True}),
            ('GET', '/metrics')]
    got, want = both(engines, reqs)
    assert [s for s, _ in got] == [s for s, _ in want] == \
        [200, 200, 200, 404, 200, 200, 200, 200, 200, 200, 200]
    for i in (0, 1, 3, 4, 5, 6, 7, 8):
        assert_same(got[i][1], want[i][1])
    assert got[0][1]['data'][0]['id'] == 'llama'
    assert got[1][1]['choices'][0]['message']['content'] == \
        want[1][1]['choices'][0]['message']['content'] != ''
    content = got[4][1]['choices'][0]['logprobs']['content']
    assert len(content) == got[4][1]['usage']['completion_tokens'] == 6
    for e in content:
        assert e['bytes'] == list(e['token'].encode('utf-8'))
        alt = [a['logprob'] for a in e['top_logprobs']]
        assert len(alt) == 3 and alt == sorted(alt, reverse=True)
    # the chat stream: the same text as the non-stream reply, the same
    # frame keys, and the [DONE] sentinel
    g_text, g_keys, g_last = stream_text(
        got[2][1], lambda c: c['delta'].get('content'))
    w_text, w_keys, w_last = stream_text(
        want[2][1], lambda c: c['delta'].get('content'))
    assert g_text == w_text == got[1][1]['choices'][0]['message']['content']
    assert g_keys == w_keys and g_last == w_last == '[DONE]'
    assert got[2][1][0]['choices'][0]['delta'] == {'role': 'assistant',
                                                   'content': None}
    # /generate's stream: JSON lines ending on the same count and reason
    assert got[9][1][-1] == want[9][1][-1]
    assert ''.join(x['text'] for x in got[9][1]) == \
        ''.join(x['text'] for x in want[9][1])
    # /metrics: every counter of the JAX server, typed alike (each engine
    # adds gauges of its own)
    types_of = [{ln.split()[2]: ln.split()[3] for ln in text.splitlines()
                 if ln.startswith('# TYPE')} for text in (got[10][1],
                                                         want[10][1])]
    # the JAX server's counters (lmdeploy_tpu/serve/openai/api_server.py)
    assert tserver.COUNTERS == {'requests', 'finished', 'canceled',
                                'errors', 'rejected', 'timeout',
                                'generated_tokens'}
    counters = {f'lmdeploy_{k}_total' for k in tserver.COUNTERS}
    shared = types_of[0].keys() & types_of[1].keys()
    assert counters | {'lmdeploy_slots_busy', 'lmdeploy_queue_depth'} \
        <= shared
    assert all(types_of[0][n] == types_of[1][n] for n in shared)
    assert float(next(ln for ln in got[10][1].splitlines() if ln.startswith(
        'lmdeploy_generated_tokens_total ')).split()[1]) > 0


COMPLETION = {'model': 'llama', 'prompt': 'once upon%', 'max_tokens': 4,
              'ignore_eos': True}


def test_completions_match_jax(engines):
    """tests/test_serve.py's completions cases: a prompt, echo, a list of
    prompts, SSE streaming, a streamed list (400), logprobs, n > 1,
    logprobs=0, prompt scoring (echo + logprobs + max_tokens=0), echo with
    alternatives on prompt and generated positions, suffix (400), and a
    streamed request with logprobs, with and without echo."""
    prompt = 'hello world again%'
    reqs = [('POST', '/v1/completions', COMPLETION),
            ('POST', '/v1/completions', dict(COMPLETION, echo=True)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt=['alpha beta%', 'gamma delta%'])),
            ('POST', '/v1/completions', dict(COMPLETION, stream=True)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt=['a', 'b'], stream=True)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt='abc%', logprobs=1)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt=['p one%', 'p two%'], n=2,
                  max_tokens=3, temperature=0.9, top_p=0.9)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt='abc%', max_tokens=2, logprobs=0)),
            ('POST', '/v1/completions',
             {'model': 'llama', 'prompt': prompt, 'max_tokens': 0,
              'echo': True, 'logprobs': 1}),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt=prompt, max_tokens=2, echo=True,
                  logprobs=2)),
            ('POST', '/v1/completions', {'model': 'llama', 'prompt': 'x',
                                         'suffix': 'y'}),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt='abc%', max_tokens=3, logprobs=1,
                  stream=True)),
            ('POST', '/v1/completions',
             dict(COMPLETION, prompt='abc%', max_tokens=3, logprobs=1,
                  stream=True, echo=True)),
            ('POST', '/v1/completions',
             dict(COMPLETION, max_tokens=0, stream=True))]
    got, want = both(engines, reqs)
    assert [s for s, _ in got] == [s for s, _ in want] == \
        [200, 200, 200, 200, 400, 200, 200, 200, 200, 200, 400, 200, 200,
         400]
    for i in (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 13):
        assert_same(got[i][1], want[i][1])
    body = got[6][1]
    assert [c['index'] for c in body['choices']] == [0, 1, 2, 3]
    assert body['usage']['completion_tokens'] == 12
    scored = got[8][1]['choices'][0]
    assert scored['text'] == prompt
    assert scored['logprobs']['token_logprobs'][0] is None
    for i in (3, 11, 12):
        g_text, g_keys, g_last = stream_text(got[i][1], lambda c: c['text'])
        w_text, w_keys, w_last = stream_text(want[i][1], lambda c: c['text'])
        assert g_text == w_text and g_keys == w_keys and g_last == '[DONE]'
        lps = [x for f in got[i][1] if isinstance(f, dict)
               and f['choices'][0]['logprobs']
               for x in f['choices'][0]['logprobs']['token_logprobs']]
        wlps = [x for f in want[i][1] if isinstance(f, dict)
                and f['choices'][0]['logprobs']
                for x in f['choices'][0]['logprobs']['token_logprobs']]
        assert_same(lps, wlps)
    assert got[12][1][0]['choices'][0]['text'] == 'abc%'


BAD_BODIES = [
    ('/v1/chat/completions', {'messages': 'hi'}),                 # no model
    ('/v1/chat/completions', {'model': 'llama'}),                 # no messages
    ('/v1/chat/completions', {'model': 'llama', 'messages': 5}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': ['a', 'b']}),
    ('/v1/chat/completions', {'model': 'llama',
                              'messages': [{'role': 'user', 'content': 1}]}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': 'hi',
                              'max_tokens': 'abc'}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': 'hi',
                              'max_tokens': 1.5}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': 'hi',
                              'stop': 2}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': 'hi',
                              'stop': [1]}),
    ('/v1/chat/completions', {'model': 'llama', 'messages': 'hi',
                              'stream': 'maybe'}),
    ('/v1/chat/completions', {'model': 7, 'messages': 'hi'}),
    ('/v1/chat/completions', [1, 2]),
    ('/v1/chat/completions', 'not json'),
    ('/v1/completions', {'model': 'llama'}),
    ('/v1/completions', {'model': 'llama', 'prompt': 3}),
    ('/v1/completions', {'model': 'llama', 'prompt': 'x',
                         'logprobs': 'many'}),
    ('/v1/completions', {'model': 'llama', 'prompt': 'x', 'n': None,
                         'echo': 'yes', 'max_tokens': '2'}),   # valid
    ('/v1/embeddings', {}),
    ('/v1/embeddings', {'input': 5}),
    ('/generate', {}),
    ('/generate', {'prompt': 'x', 'instance_id': None}),
    ('/generate', {'prompt': 'x', 'request_output_len': 'ten'}),
    ('/generate', {'prompt': 'x', 'sequence_start': 'perhaps'}),
    ('/generate', {'prompt': 'x', 'request_output_len': '2',
                   'sequence_end': 1, 'instance_id': 5.0}),     # valid
]


def test_malformed_bodies_get_the_jax_status(engines):
    """Each body the JAX models reject gets the same HTTP 400 with an
    ErrorResponse of the same keys and code from the port; bodies they
    accept (lax conversions) are served by both."""
    reqs = [('POST', path, None, body) if isinstance(body, str)
            else ('POST', path, body) for path, body in BAD_BODIES]
    got, want = both(engines, reqs)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert sum(s == 400 for s, _ in got) == len(BAD_BODIES) - 2
    for (gs, g), (ws, w) in zip(got, want):
        if gs == 400:
            assert list(g) == list(w) == ['object', 'message', 'code']
            assert g['code'] == w['code'] == 400


def test_overloaded_engine_answers_429(engines, monkeypatch):
    """With the engine's queue saturated, chat, completions and /generate
    answer 429 on both servers; models and embeddings still answer."""
    for eng in engines:
        monkeypatch.setattr(eng.engine, 'overloaded', lambda: True)
    reqs = [('POST', '/v1/chat/completions', CHAT),
            ('POST', '/v1/completions', COMPLETION),
            ('POST', '/generate', {'prompt': 'x'}),
            ('GET', '/v1/models'),
            ('POST', '/v1/embeddings', {'input': 'x'})]
    got, want = both(engines, reqs)
    assert [s for s, _ in got] == [s for s, _ in want] == \
        [429, 429, 429, 200, 200]
    assert_same(got[0][1], want[0][1])


def test_stop_strings_and_stop_flag_match_jax(engines):
    """OpenAI stop strings end a request where the stop text would
    appear (a multi-token string included); the bool ``stop`` cancels the
    session; the serving layer expands stop strings to the same stop
    sequences."""
    port, ref = engines
    # the cycling model continues '%' (id 40) with ids 99, 5, 60, 17, ...
    for stops in ('b', ['zz', 'b'], 'x'):
        assert port._gen_config(8, 1, 1.0, 1.0, 1.0, False, None,
                                stop_strings=stops).stop_words == \
            ref._gen_config(8, 1, 1.0, 1.0, 1.0, False, None,
                            stop_strings=stops).stop_words
    text = bytes([99 - 3, 5 - 3, 60 - 3, 17 - 3]).decode('latin-1')
    reqs = [('POST', '/v1/chat/completions',
             dict(CHAT, stop=text[1:3], renew_session=True)),
            ('POST', '/v1/completions', dict(COMPLETION, stop=[text[2]])),
            ('POST', '/v1/chat/completions', dict(CHAT, stop=True))]
    got, want = both(engines, reqs)
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws == 200
        assert_same(g, w)
    assert got[0][1]['choices'][0]['finish_reason'] == 'stop'
    assert got[2][1]['choices'][0]['finish_reason'] is None


def test_partial_utf8_frames_are_held(engines, monkeypatch):
    """A streamed frame whose delta decodes to a trailing replacement char
    is held back and sent with the next token, on both servers
    (tests/test_serve.py::test_stream_holds_partial_utf8_frames)."""
    def fake_decode(ids, offset=None):
        n = len(ids) - (offset or 0)
        return '�' if n == 1 else 'y' * n
    for eng in engines:
        monkeypatch.setattr(eng.tokenizer, 'decode', fake_decode)
    reqs = [('POST', '/generate', {'prompt': 'partial utf8', 'stream': True,
                                   'instance_id': 31, 'top_k': 1,
                                   'request_output_len': 4,
                                   'ignore_eos': True, 'sequence_end': True})]
    got, want = both(engines, reqs)
    for frames in (got[0][1], want[0][1]):
        texts = [f['text'] for f in frames]
        assert all('�' not in t for t in texts[:-1])
        assert sum(t.count('y') for t in texts) == 4
    assert got[0][1][-1] == want[0][1][-1]


def test_session_id_matches_jax_and_is_stable():
    """The md5 session id of a client host and its X-Session-Id header is
    the JAX server's, and no salted hash() enters it."""
    from aiohttp.test_utils import make_mocked_request
    for headers in ({'X-Session-Id': 'sess'}, {}, {'x-session-id': '7'}):
        req = make_mocked_request('POST', '/v1/chat/completions',
                                  headers=headers)
        got = tserver.session_id(req.remote, req.headers)
        assert got == jserver._session_id(req)
        assert got == tserver.session_id(req.remote, dict(headers))
        host = (req.remote or '127.0.0.1') + next(iter(headers.values()),
                                                  '')
        assert got == int.from_bytes(
            hashlib.md5(host.encode()).digest()[:4], 'big') % (2 ** 30)


def test_core_without_aiohttp_matches_the_app(engines):
    """The transport-free core, called directly, gives the app's statuses
    and bodies (and the stream the app sends), with no aiohttp import."""
    port, _ = engines
    reqs = [('GET', '/v1/models', None),
            ('POST', '/v1/chat/completions', dict(CHAT, renew_session=True)),
            ('POST', '/v1/chat/completions',
             dict(CHAT, stream=True, renew_session=True)),
            ('POST', '/v1/completions', dict(COMPLETION, echo=True,
                                             logprobs=1)),
            ('POST', '/v1/embeddings', {'input': 'abc'}),
            ('POST', '/generate', {'prompt': 'zap%', 'instance_id': 97,
                                   'request_output_len': 4,
                                   'sequence_end': True}),
            ('POST', '/v1/chat/completions', dict(CHAT, model='nope')),
            ('POST', '/v1/chat/completions', {'messages': 1})]
    app = serve(port, tserver.build_app, reqs)

    async def direct():
        out = []
        for method, path, body in reqs:
            status, payload = await tserver.ROUTES[method, path](
                port, body, '127.0.0.1', {})
            if not isinstance(payload, (dict, str)):
                payload = _sse(''.join([x async for x in payload]))
            out.append((status, payload))
        return out
    core = asyncio.run(direct())
    assert [s for s, _ in core] == [s for s, _ in app] == \
        [200, 200, 200, 200, 200, 200, 404, 400]
    for i, ((_, c), (_, a)) in enumerate(zip(core, app)):
        if i == 2:
            assert stream_text(c, lambda x: x['delta'].get('content')) == \
                stream_text(a, lambda x: x['delta'].get('content'))
        else:
            assert_same(c, a)


def _stub_gradio():
    """A stand-in for the gradio module that captures the callbacks
    (tests/test_serve.py::test_gradio_callbacks_headless's)."""
    handlers = {}

    class _Ctx:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def component(name):
        def make(*a, **k):
            c = types.SimpleNamespace(submit=lambda *a, **k: None,
                                      click=lambda *a, **k: None)
            if name == 'textbox':
                c.submit = lambda fn, *a, **k: handlers.setdefault('chat',
                                                                   fn)
            if name == 'button':
                key = 'reset' if 'cancel' in handlers else 'cancel'
                handlers[key] = None
                c.click = lambda fn, *a, **k: handlers.__setitem__(key, fn)
            return c
        return make

    gr = types.SimpleNamespace(
        Blocks=_Ctx, Column=_Ctx, Row=_Ctx, State=component('state'),
        Chatbot=component('chatbot'), Textbox=component('textbox'),
        Button=component('button'), Slider=component('slider'),
        Markdown=component('markdown'), update=lambda **k: k,
        Request=object)
    return gr, handlers


def test_gradio_callbacks_headless_match_jax(engines):
    """The gradio app's chat / cancel / reset handlers run against the
    port's AsyncEngine with a stub gradio module, and the chat turn gives
    the JAX app's history."""
    from lmdeploy_tpu.serve.gradio import app as japp
    from lmdeploy_tpu_torch.serve.gradio import app as tapp
    results = []
    for mod, eng in ((tapp, engines[0]), (japp, engines[1])):
        gr, handlers = _stub_gradio()
        mod.build_blocks(eng, gr)
        assert set(handlers) == {'chat', 'cancel', 'reset'}
        req = types.SimpleNamespace(session_hash='abc')

        async def chat():
            return [f async for f in handlers['chat'](
                'hi there%', [], None, None, 8, 0.8, 0.01, req)]
        frames = asyncio.run(chat())
        assert len(frames) >= 3
        assert frames[0][2] == {'interactive': True}
        assert frames[-1][2:4] == ({'interactive': False},
                                   {'interactive': True})
        out = asyncio.run(handlers['cancel']([], None, None, req))
        assert out[1] == {'interactive': False}
        assert asyncio.run(handlers['reset']([], req)) == ([], [])
        results.append(frames[-1][0])
    assert results[0] == results[1]
    assert results[0][-1][0] == 'hi there%' and results[0][-1][1]


def test_api_client_against_a_live_server(engines):
    """api_client.get_streaming_response (urllib) streams /generate from a
    live port server on a local socket: the chunks add up to the
    non-streamed reply, and the last carries the token count."""
    from aiohttp import ClientSession

    from lmdeploy_tpu_torch.serve.openai import api_client
    port, _ = engines

    async def run():
        server = TestServer(tserver.build_app(port), host='127.0.0.1')
        await server.start_server()
        try:
            url = f'http://127.0.0.1:{server.port}/generate'
            loop = asyncio.get_running_loop()
            chunks = await loop.run_in_executor(None, lambda: list(
                api_client.get_streaming_response(
                    'once upon%', url, 77, request_output_len=5,
                    sequence_end=True, ignore_eos=True)))
            async with ClientSession() as session:
                async with session.post(url, json={
                        'prompt': 'once upon%', 'instance_id': 78,
                        'request_output_len': 5, 'sequence_end': True,
                        'ignore_eos': True}) as r:
                    whole = await r.json()
        finally:
            await server.close()
        return chunks, whole
    chunks, whole = asyncio.run(run())
    assert ''.join(c[0] for c in chunks) == whole['text'] != ''
    assert chunks[-1][1:] == (5, 'length') == (whole['tokens'],
                                               whole['finish_reason'])


def test_main_flags_and_device(monkeypatch):
    """The server's flags are the JAX server's plus --device; main builds
    its AsyncEngine on that device and hands the app to aiohttp."""
    args = tserver.parse_args(['ws', '--port', '8080', '--tp', '1',
                               '--quant-policy', '4', '--speculative-k',
                               '2', '--device', 'cpu'])
    assert vars(args) == dict(model_path='ws', server_name='0.0.0.0',
                              server_port=8080, instance_num=32, tp=1, pp=1,
                              dp=1, quant_policy=4, speculative_k=2,
                              device='cpu')
    seen = {}

    class FakeEngine:
        def __init__(self, path, **kw):
            seen.update(kw, path=path)

    import aiohttp.web
    monkeypatch.setattr(tserver, 'AsyncEngine', FakeEngine)
    monkeypatch.setattr(aiohttp.web, 'run_app',
                        lambda app, host, port: seen.update(
                            app=app, host=host, port=port))
    tserver.main(**vars(args))
    assert seen['device'] == 'cpu' and seen['quant_policy'] == 4
    assert (seen['path'], seen['host'], seen['port']) == ('ws', '0.0.0.0',
                                                          8080)
    routes = {(r.method, r.resource.canonical)
              for r in seen['app'].router.routes()}
    assert set(tserver.ROUTES) <= routes


def test_gradio_run_server_needs_gradio(monkeypatch):
    """run_server imports gradio where it starts the UI, and says what to
    use instead when it is missing; importing the module needs none."""
    import sys

    from lmdeploy_tpu_torch.serve.gradio import app as tapp
    monkeypatch.setitem(sys.modules, 'gradio', None)
    with pytest.raises(SystemExit, match='gradio is not installed'):
        tapp.run_server('unused', device='cpu')
