"""Read a converted workspace and carry parameters across from numpy.

A workspace (``lmdeploy_tpu/convert/converter.py``) is a directory with
``config.json`` and one flat ``weights.safetensors``: dense tensors in
bf16, and each W4A16 projection as ``<name>.packed`` (column-pair
``pack_int4`` bytes, [L, K, N/2]), ``<name>.scales`` and ``<name>.zeros``
([L, G, N], bf16).  The safetensors header is parsed here with ``json``
and numpy; the ``safetensors``, ``ml_dtypes`` and JAX packages are not
needed.
"""
from __future__ import annotations

import dataclasses
import json
import os.path as osp
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models.llama import packable
from ..ops.linear import (PackedInt4Weight, QuantizedWeight, pack_quantized,
                          unpack_int4)

_NP_DTYPES = {'F32': np.float32, 'F16': np.float16, 'F64': np.float64,
              'I64': np.int64, 'I32': np.int32, 'I16': np.int16,
              'I8': np.int8, 'U8': np.uint8, 'BOOL': np.bool_,
              'BF16': np.uint16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file as a CPU torch tensor."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == '__metadata__':
            continue
        begin, end = meta['data_offsets']
        dtype = meta['dtype']
        arr = np.frombuffer(data[begin:end], _NP_DTYPES[dtype]).reshape(
            meta['shape'])
        t = torch.from_numpy(arr.copy())
        if dtype == 'BF16':
            t = t.view(torch.int16).view(torch.bfloat16)
        out[name] = t
    return out


def _tensor(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, by dtype name) -> torch."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device='cuda') -> Dict[str, Any]:
    """The JAX package's parameter tree, given as numpy arrays, as the
    port's parameters on ``device``.

    Dense leaves keep their dtype.  Quantized weights arrive as
    ``{'qvals', 'scales', 'zeros'}`` (byte-per-int4; packed to
    :class:`PackedInt4Weight` when packable) or ``{'packed', 'scales',
    'sz'}`` (already nibble-packed: a plain byte copy)."""
    out: Dict[str, Any] = {}
    for key, v in tree.items():
        if isinstance(v, dict) and {'qvals', 'scales', 'zeros'} <= set(v):
            qw = QuantizedWeight(qvals=_tensor(v['qvals'], device),
                                 scales=_tensor(v['scales'], device),
                                 zeros=_tensor(v['zeros'], device))
            out[key] = pack_quantized(qw) if packable(qw) else qw
        elif isinstance(v, dict) and {'packed', 'scales', 'sz'} <= set(v):
            packed = _tensor(v['packed'], device)
            scales = _tensor(v['scales'], device)
            if scales.dim() == 3:
                scales = scales[:, :, None, :]
            out[key] = PackedInt4Weight(packed=packed.contiguous(),
                                        scales=scales.contiguous(),
                                        sz=_tensor(v['sz'], device))
        elif isinstance(v, dict):
            out[key] = params_from_numpy(v, device)
        else:
            out[key] = _tensor(v, device)
    return out


def load_workspace(src: str, device='cuda'):
    """Returns (ModelConfig, EngineConfig | None, params, kv_scales | None);
    ``kv_scales`` are the workspace's calibrated KV qparams, four lists
    (k_scale, k_zp, v_scale, v_zp) as ``lite/apis/kv_qparams.py`` writes
    them."""
    with open(osp.join(src, 'config.json')) as f:
        payload = json.load(f)
    cfg = ModelConfig.from_dict(payload['model'])
    ecfg: Optional[EngineConfig] = None
    if 'engine' in payload:
        d = dict(payload['engine'])
        d['prefill_buckets'] = tuple(d.get('prefill_buckets',
                                           (128, 512, 2048)))
        # prefix caching is not ported: the workspace's setting (the JAX
        # converter saves True by default) is not taken
        d.pop('enable_prefix_caching', None)
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        ecfg = EngineConfig(**{k: v for k, v in d.items() if k in known})
    flat = read_safetensors(osp.join(src, 'weights.safetensors'))
    tree: Dict[str, Any] = {}
    for key, t in flat.items():
        if key.endswith(('.packed', '.scales', '.zeros')):
            base, part = key.rsplit('.', 1)
            node, leaf = _node(tree, base)
            q = node.setdefault(leaf, {})
            if part == 'packed':     # column-pair disk packing
                q['qvals'] = unpack_int4(t.numpy())
            else:
                q[part] = t
        else:
            node, leaf = _node(tree, key)
            node[leaf] = t
    return (cfg, ecfg, params_from_numpy(tree, device),
            payload.get('kv_scales'))


def _node(tree: dict, key: str):
    parts = key.split('/')
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    return node, parts[-1]


def is_workspace(path: str) -> bool:
    return osp.exists(osp.join(path, 'weights.safetensors'))


__all__ = ['read_safetensors', 'params_from_numpy', 'load_workspace',
           'is_workspace']
