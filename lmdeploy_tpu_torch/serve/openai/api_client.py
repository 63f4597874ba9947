"""Minimal client for the server's /generate endpoint, over urllib.

Copy of ``lmdeploy_tpu/serve/openai/api_client.py`` (reference:
lmdeploy/serve/openai/api_client.py ``get_streaming_response``); it
needs no package beyond the standard library.

    python -m lmdeploy_tpu_torch.serve.openai.api_client http://host:23333
"""
from __future__ import annotations

import json
from typing import Iterable, Tuple, Union


def get_streaming_response(
        prompt: str, api_url: str, instance_id: int,
        request_output_len: int = 512, stream: bool = True,
        sequence_start: bool = True, sequence_end: bool = False,
        ignore_eos: bool = False
) -> Iterable[Tuple[str, int, Union[str, None]]]:
    """Yield (text, tokens, finish_reason) chunks from /generate."""
    import urllib.request
    headers = {'User-Agent': 'lmdeploy-tpu client',
               'Content-Type': 'application/json'}
    pload = {
        'prompt': prompt,
        'stream': stream,
        'instance_id': instance_id,
        'request_output_len': request_output_len,
        'sequence_start': sequence_start,
        'sequence_end': sequence_end,
        'ignore_eos': ignore_eos,
    }
    req = urllib.request.Request(api_url, json.dumps(pload).encode(),
                                 headers)
    with urllib.request.urlopen(req) as resp:
        buf = b''
        for raw in resp:
            buf += raw
            while b'\n' in buf:
                line, buf = buf.split(b'\n', 1)
                if not line.strip():
                    continue
                data = json.loads(line)
                yield (data['text'], data['tokens'],
                       data.get('finish_reason'))


def main(api_server_url: str = 'http://0.0.0.0:23333',
         session_id: int = 0):
    """Interactive terminal chat against a running server."""
    nth_round = 1
    while True:
        prompt = input('\ndouble enter to end input >>> ')
        if prompt in ('exit', 'end'):
            break
        for text, tokens, finish in get_streaming_response(
                prompt, f'{api_server_url}/generate', session_id,
                sequence_start=(nth_round == 1)):
            print(text, end='', flush=True)
        nth_round += 1


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch api_client')
    ap.add_argument('url', nargs='?', default='http://0.0.0.0:23333')
    ap.add_argument('--session-id', type=int, default=0)
    a = ap.parse_args()
    main(a.url, a.session_id)
