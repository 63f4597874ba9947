"""CLI dispatcher: ``python -m lmdeploy_tpu_torch.cli.main <command> ...``

Commands mirror the reference's python -m entrypoints:
  chat      interactive terminal chat       (lmdeploy.turbomind.chat)
  convert   checkpoint -> workspace         (lmdeploy.serve.turbomind.deploy)
  serve     OpenAI-compatible API server    (lmdeploy.serve.openai.api_server)
  decode    prompt logits / perplexity      (lmdeploy.turbomind.decode)

``chat``, ``serve`` and ``decode`` take ``--device cpu`` to run on the CPU
(the default is CUDA).  ``lite`` and ``chat-baseline`` belong to the JAX
package and are not ported yet.
"""
from __future__ import annotations

import sys

# commands of the JAX package's CLI that the port does not have yet, and
# where ROADMAP.md queues them
NOT_PORTED = {
    'lite': 'ROADMAP.md Queue 1 item "The remaining benchmarks and tools" '
            '(the rest of lite/)',
    'chat-baseline': 'ROADMAP.md Queue 1 item "The remaining benchmarks '
                     'and tools" (pytorch/, the HF eager backend)',
}


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
    if cmd in NOT_PORTED:
        print(f'{cmd}: not ported to lmdeploy_tpu_torch yet; '
              f'{NOT_PORTED[cmd]} brings it')
        return 1
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
