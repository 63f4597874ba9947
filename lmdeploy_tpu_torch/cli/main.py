"""CLI dispatcher: ``python -m lmdeploy_tpu_torch.cli.main <command> ...``

Commands mirror the reference's python -m entrypoints:
  chat      interactive terminal chat       (lmdeploy.turbomind.chat)
  convert   checkpoint -> workspace         (lmdeploy.serve.turbomind.deploy)
  serve     OpenAI-compatible API server    (lmdeploy.serve.openai.api_server)
  decode    prompt logits / perplexity      (lmdeploy.turbomind.decode)
  lite      quantisation toolkit: calibrate, auto_awq, kv_qparams
                                            (lmdeploy.lite.apis)
  chat-baseline  HF eager baseline chat     (lmdeploy.pytorch.chat)

``chat``, ``serve``, ``decode``, ``chat-baseline``, ``lite calibrate`` and
``lite auto_awq`` take ``--device cpu`` to run on the CPU (the default is
CUDA).  ``chat-baseline`` needs the ``transformers`` package.
"""
from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ('-h', '--help'):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == 'chat':
        from .chat import main as chat_main
        return chat_main(rest[0], **_kw(rest[1:]))
    if cmd == 'convert':
        from ..convert.converter import main as conv_main
        return conv_main(rest)
    if cmd == 'serve':
        from ..serve.openai.api_server import main as serve_main
        return serve_main(rest[0], **_kw(rest[1:]))
    if cmd == 'decode':
        from .decode import main as decode_main
        pos, kw = _args(rest)
        decode_main(pos[0], pos[1:], **kw)
        return 0
    if cmd == 'lite':
        from ..lite.cli import main as lite_main
        return lite_main(rest)
    if cmd == 'chat-baseline':
        from ..pytorch.chat import main as pt_main
        pt_main(rest[0], **_kw(rest[1:]))
        return 0
    print(f'unknown command: {cmd}\n{__doc__}')
    return 1


def _kw(rest):
    return _args(rest)[1]


def _args(rest):
    """(positional arguments, {flag: value}) of ``--flag value`` pairs,
    numbers parsed."""
    pos, out = [], {}
    i = 0
    while i < len(rest):
        if rest[i].startswith('--'):
            key = rest[i][2:].replace('-', '_')
            val = rest[i + 1] if i + 1 < len(rest) else 'true'
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
            out[key] = val
            i += 2
        else:
            pos.append(rest[i])
            i += 1
    return pos, out


if __name__ == '__main__':
    raise SystemExit(main())
