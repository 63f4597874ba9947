"""Calibration runner over the port's own forward.

Port of ``lmdeploy_tpu/lite/quantization/calibration.py``
(``target_linear_names``, ``CalibrationContext``, ``load_stats``).  The
JAX package runs an HF ``transformers`` model and hooks each target
linear's input; the card's machine has no ``transformers``, so the port
loads the checkpoint with ``convert/hf.py::load_hf_dir`` and runs each
sample as one prefill pass through ``models/llama.py::forward_layers`` on
a scratch pool, whose calibration hook hands over each projection's input
and the K / V each layer stores.  The hook's four points map to the HF
linear names (:data:`HOOK_LINEARS`), so the export has the JAX package's
keys.

Precision: on the CPU the forward runs in f32, as the JAX package's HF
forward does (``lite/apis/calibrate.py``); on the card it runs in bf16
(weights, activations and pool), through the prefill-attention kernel
(bf16 only) with the dense projections on ``torch.matmul``, as
``build_engine`` serves an HF directory.  K is taken after rope, as HF's
``past_key_values`` holds it.

Qwen's layers are named ``transformer.h.<i>``: the port records its stats
under those names (the JAX context looks for ``model.layers.<i>`` names
and so records no input stats for qwen).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...config import ModelConfig
from ...kvcache.paged import init_cache
from ...models.llama import StepBatch, embed_tokens, forward_layers
from .awq import FC_FCS_MAP, NORM_FCS_MAP, _family
from .observer import ActivationObserver, KVCacheObserver

# the calibration hook's points -> the HF linears that take each as input
_LLAMA_HOOKS = {
    'attn_in': ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj'),
    'attn_out': ('self_attn.o_proj',),
    'ffn_in': ('mlp.gate_proj', 'mlp.up_proj'),
    'ffn_act': ('mlp.down_proj',),
}
HOOK_LINEARS = {
    'llama': _LLAMA_HOOKS,
    'internlm': _LLAMA_HOOKS,
    'qwen': {'attn_in': ('attn.c_attn',), 'attn_out': ('attn.c_proj',),
             'ffn_in': ('mlp.w1', 'mlp.w2'), 'ffn_act': ('mlp.c_proj',)},
}


def layer_prefix(model_name: str) -> str:
    """The HF name of the decoder layer list of ``model_name``'s family."""
    return 'transformer.h' if _family(model_name) == 'qwen' \
        else 'model.layers'


def target_linear_names(model_name: str, num_layers: int,
                        layer_prefix: str = 'model.layers') -> List[str]:
    fam = _family(model_name)
    rel = set()
    for fcs in NORM_FCS_MAP[fam].values():
        rel.update(fcs)
    for fc, fcs in FC_FCS_MAP[fam].items():
        rel.add(fc)
        rel.update(fcs)
    return [f'{layer_prefix}.{i}.{r}'
            for i in range(num_layers) for r in sorted(rel)]


class CalibrationContext:
    """Collects activation + KV stats of one model.

    ``params`` is the port's parameter tree on the device to calibrate on
    (dense f32 on the CPU, bf16 on the card; :func:`load_model` loads an
    HF directory so).  Usage::

        ctx = CalibrationContext(cfg, params, model_name)
        with ctx:
            for ids in samples:
                ctx.step(ids)            # LongTensor [B, S]
        np.savez(..., **ctx.export())
    """

    PAGE_SIZE = 64      # the scratch pool's pages (the engine's default)

    def __init__(self, cfg: ModelConfig, params, model_name: str = ''):
        self.cfg = cfg
        self.params = params
        self.model_name = model_name or cfg.model_name
        self.num_layers = cfg.num_layer
        self.num_kv_heads = cfg.kv_head_num
        self.head_dim = cfg.size_per_head
        self.device = params['tok_embedding'].device
        fam = _family(self.model_name)
        prefix = layer_prefix(self.model_name)
        dims = {'attn_in': cfg.hidden_size,
                'attn_out': cfg.head_num * cfg.size_per_head,
                'ffn_in': cfg.hidden_size, 'ffn_act': cfg.inter_size}
        # per layer: hook point -> the observers of the linears it feeds
        self._feeds = [{point: [] for point in dims}
                       for _ in range(self.num_layers)]
        self.act_observers: Dict[str, ActivationObserver] = {}
        for i in range(self.num_layers):
            for point, linears in HOOK_LINEARS[fam].items():
                for rel in linears:
                    obs = ActivationObserver(dims[point])
                    self.act_observers[f'{prefix}.{i}.{rel}'] = obs
                    self._feeds[i][point].append(obs)
        self.key_observers = [KVCacheObserver(self.num_kv_heads,
                                              self.head_dim)
                              for _ in range(self.num_layers)]
        self.value_observers = [KVCacheObserver(self.num_kv_heads,
                                                self.head_dim)
                                for _ in range(self.num_layers)]
        self._cache = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._cache = None

    def _hook(self, layer: int, point: str, x: torch.Tensor) -> None:
        if point in ('k', 'v'):
            obs = (self.key_observers if point == 'k'
                   else self.value_observers)[layer]
            # HF's past_key_values layout [B, KH, S, Dh]
            obs.observe(x.transpose(1, 2).float().cpu().numpy())
            return
        arr = x.reshape(-1, x.shape[-1]).float().cpu().numpy()
        for obs in self._feeds[layer][point]:
            obs.observe(arr)

    def step(self, input_ids) -> None:
        """One prefill pass of ``input_ids`` [B, S] from position 0."""
        ids = torch.as_tensor(input_ids).to(self.device, torch.int32)
        b, t = ids.shape
        pages = -(-t // self.PAGE_SIZE)
        cfg = self.cfg
        if self._cache is None or self._cache.num_pages < b * pages:
            self._cache = None
            self._cache = init_cache(
                cfg.num_layer, b * pages, self.PAGE_SIZE, cfg.kv_head_num,
                cfg.size_per_head, self.params['tok_embedding'].dtype,
                self.device)
        dev = self.device
        batch = StepBatch(
            ids=ids,
            positions=torch.arange(t, dtype=torch.int32,
                                   device=dev).expand(b, t),
            valid=torch.ones((b, t), dtype=torch.bool, device=dev),
            context_len=torch.full((b,), t, dtype=torch.int32, device=dev),
            page_table=torch.arange(b * pages, dtype=torch.int32,
                                    device=dev).reshape(b, pages))
        with torch.no_grad():
            forward_layers(self.params, self._cache, batch,
                           embed_tokens(self.params, ids), cfg,
                           hook=self._hook)

    def export(self) -> Dict[str, np.ndarray]:
        """Flat dict for np.savez: inputs/<name>/<stat>, keys/<i>/<stat>,
        values/<i>/<stat> (the JAX package's keys)."""
        out: Dict[str, np.ndarray] = {}
        for name, obs in self.act_observers.items():
            for stat, val in obs.stats().items():
                out[f'inputs/{name}/{stat}'] = val
        for i in range(self.num_layers):
            for stat, val in self.key_observers[i].stats().items():
                out[f'keys/{i}/{stat}'] = val
            for stat, val in self.value_observers[i].stats().items():
                out[f'values/{i}/{stat}'] = val
        return out


def load_model(model_dir: str, device='cuda'
               ) -> Tuple[ModelConfig, Dict[str, object]]:
    """An HF (or meta-llama) directory as dense parameters for calibration
    on ``device``: f32 on the CPU, bf16 on the card."""
    from ...convert.hf import load_hf_dir
    from ...convert.workspace import params_from_numpy
    from ...engine.engine import resolve_device
    dev = resolve_device(device)
    dtype = torch.float32 if dev.type == 'cpu' else torch.bfloat16
    cfg, params = load_hf_dir(model_dir, dtype)
    return cfg, params_from_numpy(params, dev)


Stats = Dict[int, Dict[str, np.ndarray]]


def load_stats(path: str) -> Tuple[Dict[str, Dict[str, np.ndarray]], Stats,
                                   Stats]:
    """Inverse of :meth:`CalibrationContext.export` (reads the .npz):
    (inputs by linear name, keys by layer, values by layer)."""
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


__all__ = ['CalibrationContext', 'HOOK_LINEARS', 'layer_prefix',
           'load_model', 'target_linear_names', 'load_stats']
