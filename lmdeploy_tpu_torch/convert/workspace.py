"""Read and write a converted workspace; carry parameters across from
numpy.

A workspace (``convert/converter.py`` writes one) is a directory with
``config.json`` and one flat ``weights.safetensors``: dense tensors in
bf16, and each W4A16 projection as ``<name>.packed`` (column-pair
``pack_int4`` bytes, [L, K, N/2]), ``<name>.scales`` and ``<name>.zeros``
([L, G, N], bf16).  The safetensors file is read and written here with
``json``, ``struct`` and numpy; the ``safetensors``, ``ml_dtypes`` and
JAX packages are not needed.  :func:`save_workspace` ports the JAX
converter's writer, so each package reads the other's workspaces.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models.llama import packable
from ..ops.cuda.quant_matmul import unpack_nibbles
from ..ops.linear import (PackedInt4Weight, QuantizedWeight, pack_quantized,
                          unpack_int4)

_NP_DTYPES = {'F32': np.float32, 'F16': np.float16, 'F64': np.float64,
              'I64': np.int64, 'I32': np.int32, 'I16': np.int16,
              'I8': np.int8, 'U8': np.uint8, 'BOOL': np.bool_,
              'BF16': np.uint16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file as a CPU torch tensor.  The
    file is memory-mapped and each tensor copied out of the map once, so
    a checkpoint costs one copy in host memory, not two."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
    tensors = {k: v for k, v in header.items() if k != '__metadata__'}
    size = max((m['data_offsets'][1] for m in tensors.values()), default=0)
    # np.memmap refuses an empty map
    data = np.memmap(path, np.uint8, mode='r', offset=8 + n,
                     shape=(size,)) if size else np.empty(0, np.uint8)
    out = {}
    for name, meta in tensors.items():
        begin, end = meta['data_offsets']
        dtype = meta['dtype']
        arr = np.array(data[begin:end]).view(_NP_DTYPES[dtype]).reshape(
            meta['shape'])
        t = torch.from_numpy(arr)
        if dtype == 'BF16':
            t = t.view(torch.int16).view(torch.bfloat16)
        out[name] = t
    del data
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """CPU torch tensors to a .safetensors file (the inverse of
    :func:`read_safetensors`): the little-endian u64 header length, the
    JSON header padded with spaces to 8 bytes, then every tensor's bytes
    in key order, back to back."""
    names = {v: k for k, v in _NP_DTYPES.items() if k != 'BF16'}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtype, arr = 'BF16', t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            dtype = names[arr.dtype.type]
        raw = arr.tobytes()
        header[name] = {'dtype': dtype, 'shape': list(t.shape),
                        'data_offsets': [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(',', ':')).encode()
    head += b' ' * (-len(head) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """uint8 values 0..15, [..., K, N] -> the on-disk workspace packing
    [..., K, N/2] (the inverse of :func:`unpack_int4`)."""
    return (q[..., 0::2] & 0xF) | (q[..., 1::2] << 4)


def _quantized_parts(w) -> Dict[str, torch.Tensor]:
    """A W4A16 leaf as the workspace's ``packed`` / ``scales`` / ``zeros``
    (stacked [L, ...]).  A packed-residency weight gives its zero points
    back as round(sz / s), which is exact where ``sz`` was made as
    bf16(s * z) from integer z; anything else raises."""
    if isinstance(w, QuantizedWeight):
        return {'packed': pack_int4(w.qvals.cpu()),
                'scales': w.scales.cpu().to(torch.bfloat16),
                'zeros': w.zeros.cpu().to(torch.bfloat16)}
    scales = w.scales[:, :, 0].cpu()
    zeros = torch.round(w.sz.cpu().float() / scales.float())
    if not torch.equal((scales.float() * zeros).to(w.sz.dtype), w.sz.cpu()):
        raise ValueError('save_workspace: sz is not scales * integer zero '
                         'points; save the QuantizedWeight instead')
    return {'packed': pack_int4(unpack_nibbles(w.packed.cpu())),
            'scales': scales.to(torch.bfloat16),
            'zeros': zeros.to(torch.bfloat16)}


def _flatten(params: Dict[str, Any], prefix: str = ''
             ) -> Dict[str, torch.Tensor]:
    """The parameter tree as the workspace's flat keys: f32 leaves in
    bf16, as the JAX converter stores them."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(_flatten(v, key + '/'))
        elif isinstance(v, (QuantizedWeight, PackedInt4Weight)):
            for part, t in _quantized_parts(v).items():
                out[f'{key}.{part}'] = t
        else:
            t = torch.as_tensor(v).cpu()
            out[key] = t.to(torch.bfloat16) if t.dtype == torch.float32 \
                else t
    return out


def save_workspace(dst: str, cfg: ModelConfig, params: Dict[str, Any],
                   engine_cfg: Optional[EngineConfig] = None,
                   kv_scales=None) -> None:
    """Write ``params`` (the port's tree: tensors, QuantizedWeight or
    PackedInt4Weight leaves) with ``cfg``, the optional engine config and
    KV qparams as a workspace that both packages load."""
    os.makedirs(dst, exist_ok=True)
    write_safetensors(osp.join(dst, 'weights.safetensors'),
                      _flatten(params))
    payload: Dict[str, Any] = {'model': dataclasses.asdict(cfg)}
    if engine_cfg is not None:
        d = dataclasses.asdict(engine_cfg)
        d['prefill_buckets'] = list(d['prefill_buckets'])
        payload['engine'] = d
    if kv_scales is not None:
        payload['kv_scales'] = [np.asarray(x).tolist() for x in kv_scales]
    with open(osp.join(dst, 'config.json'), 'w') as f:
        json.dump(payload, f, indent=2)


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


__all__ = ['read_safetensors', 'write_safetensors', 'pack_int4',
           'save_workspace', 'params_from_numpy', 'load_workspace',
           'is_workspace']
