"""Export static per-layer KV-cache qparams from calibration stats into a
workspace.

Port of ``lmdeploy_tpu/lite/apis/kv_qparams.py`` (per-layer export only;
per-head int4 qparams stay with the int4 path that uses them, ROADMAP.md
Queue 1 item 5) with its own :func:`load_stats`
(``lmdeploy_tpu/lite/quantization/calibration.py::load_stats``).  numpy
only.

Formula, as the reference's ``past_kv_scale`` with the zero point kept in
the quantised domain (the cache computes ``q = x / scale + zp``):
- symmetric: ``scale = absmax / qmax``, ``zp = 0``;
- asymmetric: ``scale = (max - min) / (2^bits - 1)``,
  ``zp = -((max + min) / 2) / scale``;
with qmax 127 (int8) or 7 (int4).  The workspace's ``config.json`` gets
``kv_scales`` (four [L] lists) and the engine's ``quant_policy`` /
``kv_dtype``.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Tuple

import numpy as np

Stats = Dict[int, Dict[str, np.ndarray]]


def load_stats(path: str) -> Tuple[Dict[str, Dict[str, np.ndarray]], Stats,
                                   Stats]:
    """(inputs, keys, values) of a ``calib_stats.npz``: entries
    ``inputs/<name>/<stat>``, ``keys/<layer>/<stat>``,
    ``values/<layer>/<stat>``."""
    z = np.load(path)
    inputs: Dict[str, Dict[str, np.ndarray]] = {}
    keys: Stats = {}
    values: Stats = {}
    for k in z.files:
        kind, name, stat = k.split('/', 2)
        if kind == 'inputs':
            inputs.setdefault(name, {})[stat] = z[k]
        elif kind == 'keys':
            keys.setdefault(int(name), {})[stat] = z[k]
        elif kind == 'values':
            values.setdefault(int(name), {})[stat] = z[k]
    return inputs, keys, values


def qparams_from_stats(keys: Stats, values: Stats, kv_bits: int = 8,
                       kv_sym: bool = False):
    """Per-layer f32 [L] arrays (k_scale, k_zp, v_scale, v_zp) from
    per-layer stats ``{'min', 'max', 'absmax'}`` (any shape; reduced to
    the layer's envelope)."""
    if kv_bits not in (4, 8):
        raise ValueError(f'kv_bits must be 4 or 8, got {kv_bits} (the '
                         'cache pools store int8 or nibble-packed int4)')
    nl = len(keys)
    out = [np.zeros((nl,), np.float32) for _ in range(4)]
    k_scale, k_zp, v_scale, v_zp = out
    qmax = 2 ** (kv_bits - 1) - 1       # 127 / 7
    span = 2 ** kv_bits - 1             # 255 / 15
    for i in range(nl):
        if kv_sym:
            k_scale[i] = np.max(keys[i]['absmax']) / qmax
            v_scale[i] = np.max(values[i]['absmax']) / qmax
        else:
            kmin, kmax = np.min(keys[i]['min']), np.max(keys[i]['max'])
            vmin, vmax = np.min(values[i]['min']), np.max(values[i]['max'])
            k_scale[i] = (kmax - kmin) / span
            v_scale[i] = (vmax - vmin) / span
            k_zp[i] = -((kmax + kmin) / 2) / np.maximum(k_scale[i], 1e-12)
            v_zp[i] = -((vmax + vmin) / 2) / np.maximum(v_scale[i], 1e-12)
    return k_scale, k_zp, v_scale, v_zp


def kv_qparams(work_dir: str, dst: str, kv_bits: int = 8,
               kv_sym: bool = False, stats_path: str = '') -> None:
    """Write the qparams of ``work_dir``'s calibration stats into the
    workspace ``dst`` (its config.json)."""
    stats_path = stats_path or osp.join(work_dir, 'calib_stats.npz')
    _, keys, values = load_stats(stats_path)
    k_scale, k_zp, v_scale, v_zp = qparams_from_stats(keys, values, kv_bits,
                                                      kv_sym)
    for i in range(len(k_scale)):
        print(f'layer {i}: k_scale={k_scale[i]:.6f} k_zp={k_zp[i]:.3f} '
              f'v_scale={v_scale[i]:.6f} v_zp={v_zp[i]:.3f}')
    cfg_path = osp.join(dst, 'config.json')
    with open(cfg_path) as f:
        payload = json.load(f)
    payload['kv_scales'] = [k_scale.tolist(), k_zp.tolist(),
                            v_scale.tolist(), v_zp.tolist()]
    engine = payload.setdefault('engine', {})
    engine['quant_policy'] = 8 if kv_bits == 4 else 4
    engine['kv_dtype'] = 'int4' if kv_bits == 4 else 'int8'
    with open(cfg_path, 'w') as f:
        json.dump(payload, f, indent=2)
    print(f'kv qparams -> {cfg_path}')


def main():
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.lite kv_qparams')
    ap.add_argument('work_dir')
    ap.add_argument('dst', help='workspace dir to update')
    ap.add_argument('--kv-bits', type=int, default=8)
    ap.add_argument('--kv-sym', action='store_true')
    args = ap.parse_args()
    kv_qparams(args.work_dir, args.dst, args.kv_bits, args.kv_sym)


if __name__ == '__main__':
    main()
