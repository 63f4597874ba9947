"""The port's multi-host router (``serve/router.py``) on the CPU: the six
cases of tests/test_router.py, with a REAL second process hosting its own
TorchEngine behind the TCP worker (started with ``python -c`` from this
file), and the wire frames against the JAX package's.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lmdeploy_tpu.messages as jmsg
import lmdeploy_tpu.serve.router as jrouter
import lmdeploy_tpu_torch.messages as tmsg
import lmdeploy_tpu_torch.serve.router as trouter
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import (EngineRequest, GenerationConfig,
                                         ResponseType)
from lmdeploy_tpu_torch.models.llama import init_params
from lmdeploy_tpu_torch.serve.router import RemoteEngine, RouterEngine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(head_num=2, kv_head_num=2, size_per_head=16, inter_size=64,
           num_layer=2, vocab_size=128, rotary_embedding=16,
           max_position_embeddings=128, session_len=128, end_id=2,
           weight_type='fp32')
ECFG = dict(max_batch_size=2, session_len=64, page_size=8, num_pages=32,
            max_context_token_num=16, prefill_buckets=(8, 16),
            step_length=4)

# the peer host: the same engine, warmed, then served on a TCP port
WORKER = f'''
import sys
import torch
torch.set_num_threads(1)
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.models.llama import init_params
from lmdeploy_tpu_torch.serve.router import serve_engine
cfg = ModelConfig(**{CFG!r})
params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                     'cpu')
engine = TorchEngine(cfg, EngineConfig(**{ECFG!r}), params, device='cpu')
engine.create_instance().infer(-99, [1, 2, 3], gen_config=GenerationConfig(
    max_new_tokens=2, top_k=1, ignore_eos=True), sequence_end=True)
print('READY', flush=True)
serve_engine(engine, host='127.0.0.1', port=int(sys.argv[1]))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def router():
    port = _free_port()
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.Popen([sys.executable, '-c', WORKER, str(port)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    seen = []
    try:
        while True:  # skip warnings until the worker announces readiness
            line = proc.stdout.readline().decode()
            seen.append(line)
            if 'READY' in line:
                break
            assert line and proc.poll() is None, \
                f'worker failed to start:\n{"".join(seen)}'
        cfg = ModelConfig(**CFG)
        local = TorchEngine(cfg, EngineConfig(**ECFG), init_params(
            cfg, torch.Generator().manual_seed(0), torch.float32, 'cpu'),
            device='cpu')
        r = RouterEngine(local, [f'127.0.0.1:{port}'])
        yield r
        r.shutdown()
    finally:
        proc.kill()
        proc.wait(timeout=30)


def greedy(n=8):
    return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True)


def _stream(router, sid, ids, gen, **kw):
    outs = list(router.create_instance().stream_infer(sid, ids, gen, **kw))
    assert outs[-1].finished
    return outs


def test_generation_through_remote_host(router):
    """A session routed to the PEER process streams exactly the tokens
    the local engine produces (identical params and seed)."""
    want = _stream(router, 1, [3, 7, 11], greedy(),
                   sequence_end=True)[-1].token_ids
    router._sticky[50] = 1  # pin to the remote backend
    outs = _stream(router, 50, [3, 7, 11], greedy(), sequence_end=True)
    assert outs[-1].token_ids == want and len(want) == 8
    for prev, cur in zip(outs, outs[1:]):   # monotone across the wire
        assert cur.token_ids[:len(prev.token_ids)] == prev.token_ids


def test_session_continuation_stays_on_remote(router):
    """Turn 2 of a remote session equals the single concatenated run (KV
    pages never move); sequence_end re-opens routing."""
    router._sticky[60] = 1
    t1 = _stream(router, 60, [2, 4, 6], greedy(4))[-1].token_ids
    assert router._sticky[60] == 1
    t2 = _stream(router, 60, [8, 10], greedy(4),
                 sequence_start=False, sequence_end=True)[-1].token_ids
    want = _stream(router, 61, [2, 4, 6] + t1 + [8, 10], greedy(4),
                   sequence_end=True)[-1].token_ids
    assert t2 == want
    assert 60 not in router._sticky


def test_remote_logits_path(router):
    """Prompt logits cross the wire (base64 f32) bit-exact."""
    ids = [5, 9, 13, 21]
    want = router.local.create_instance().decode(ids)
    router._sticky[-1] = 1  # decode() uses session_id=-1
    try:
        got = router.create_instance().decode(ids)
    finally:
        router._sticky.pop(-1, None)
    assert got.shape == want.shape == (4, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_balanced_routing_and_metrics(router):
    """New sessions go to the least-loaded backend; router metrics merge
    the peer's counters."""
    req = EngineRequest(session_id=900, input_ids=[1], gen_config=greedy())
    assert router._route(req) in (0, 1)
    m = router.metrics()
    assert m['router_backends'] == 2
    assert m['peer0_requests'] >= 1 and 'peer0_slots_busy' in m


def test_remote_engine_dead_peer_fails_fast():
    """A peer that disconnects fails in-flight requests AND later submits
    at once, and reports overloaded()."""
    srv = socket.socket()
    srv.bind(('localhost', 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def accept_and_close():
        conn, _ = srv.accept()
        time.sleep(0.2)
        conn.close()

    t = threading.Thread(target=accept_and_close)
    t.start()
    eng = RemoteEngine(f'localhost:{port}')
    req = EngineRequest(session_id=1, input_ids=[1, 2],
                        gen_config=GenerationConfig(max_new_tokens=2))
    out = eng.submit(req).get(timeout=5.0)
    assert out.finished and out.status == ResponseType.INTERNAL_ERROR
    t.join(timeout=10)
    assert not t.is_alive()
    deadline = time.time() + 5.0
    while not eng._dead and time.time() < deadline:
        time.sleep(0.05)
    assert eng._dead
    assert eng.submit(req).get(timeout=1.0).finished
    assert eng.overloaded()
    srv.close()


def test_malformed_frames_drop_connection_not_engine(router):
    """Garbage frames (oversize length prefix, invalid JSON, missing
    fields) drop THAT connection only; the engine keeps serving."""
    import struct
    host, port = router.remotes[0].address.rsplit(':', 1)

    def hostile(payload: bytes) -> bytes:
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(payload)
            s.settimeout(10)
            try:
                return s.recv(1)            # b'' == orderly close
            except (ConnectionResetError, socket.timeout):
                return b''

    assert hostile(struct.pack('>I', 0xFFFFFFFF) + b'x' * 64) == b''
    assert hostile(struct.pack('>I', 7) + b'not json') == b''
    body = b'{"rid": 1}'
    assert hostile(struct.pack('>I', len(body)) + body) == b''
    time.sleep(0.2)
    outs = _stream(router, 950, [3, 7, 11], greedy(), sequence_end=True)
    router._sticky[951] = 1
    remote = _stream(router, 951, [3, 7, 11], greedy(), sequence_end=True)
    assert remote[-1].token_ids == outs[-1].token_ids


def _requests(msg):
    gen = msg.GenerationConfig(max_new_tokens=7, top_k=3, top_p=0.5,
                               temperature=0.3, random_seed=11,
                               stop_words=[5, [6, 7]], top_logprobs=2)
    return [msg.EngineRequest(session_id=3, input_ids=np.arange(4),
                              gen_config=gen, sequence_end=True, step=9),
            msg.EngineRequest(session_id=-1, input_ids=[1, 2],
                              gen_config=msg.GenerationConfig(),
                              return_logits=True)]


def _outputs(msg):
    return [msg.EngineOutput(msg.ResponseType.SUCCESS, [4, 5], 2),
            msg.EngineOutput(msg.ResponseType.FINISH, [4, 5, 6], 3,
                             finished=True, logprobs=[-0.5, -1.0, -2.0]),
            msg.EngineOutput(msg.ResponseType.FINISH, [], 0, finished=True,
                             logits=np.linspace(-1, 1, 12,
                                                dtype=np.float32).reshape(
                                 3, 4))]


def test_wire_frames_match_jax():
    """_req_to_wire / _out_to_wire give the JAX package's dicts, frames
    are the same bytes, and each package decodes the other's frames."""
    for t_req, j_req in zip(_requests(tmsg), _requests(jmsg)):
        t_wire, j_wire = trouter._req_to_wire(t_req), jrouter._req_to_wire(
            j_req)
        assert t_wire == j_wire
        assert trouter._req_from_wire(dict(j_wire)) == \
            trouter._req_from_wire(dict(t_wire))
    for t_out, j_out in zip(_outputs(tmsg), _outputs(jmsg)):
        t_wire, j_wire = trouter._out_to_wire(t_out), jrouter._out_to_wire(
            j_out)
        assert t_wire == j_wire
        back = trouter._out_from_wire(j_wire)
        assert (back.status, back.token_ids, back.num_generated,
                back.finished, back.logprobs) == \
            (t_out.status, t_out.token_ids, t_out.num_generated,
             t_out.finished, t_out.logprobs)
        if t_out.logits is not None:
            np.testing.assert_array_equal(back.logits, t_out.logits)
        frames = []
        for mod, wire in ((trouter, t_wire), (jrouter, j_wire)):
            a, b = socket.socketpair()
            with a, b:
                mod._send_frame(a, dict(wire, rid=1), threading.Lock())
                frames.append(b.recv(1 << 20))
                a.sendall(frames[-1])
                assert trouter._recv_frame(b) == dict(wire, rid=1)
        assert frames[0] == frames[1]
