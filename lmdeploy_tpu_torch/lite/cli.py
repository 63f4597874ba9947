"""lite sub-CLI: ``python -m lmdeploy_tpu_torch.lite.cli
{calibrate|auto_awq|kv_qparams} ...`` (also ``cli.main lite ...``).

Port of ``lmdeploy_tpu/lite/cli.py``; ``calibrate`` and ``auto_awq`` take
``--device cpu`` to calibrate on the CPU (the default is CUDA)."""
from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ('-h', '--help'):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == 'calibrate':
        from .apis.calibrate import main as m
    elif cmd == 'auto_awq':
        from .apis.auto_awq import main as m
    elif cmd == 'kv_qparams':
        from .apis.kv_qparams import main as m
    else:
        print(f'unknown lite command: {cmd}\n{__doc__}')
        return 1
    return m(rest)


if __name__ == '__main__':
    raise SystemExit(main())
