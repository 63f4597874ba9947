"""Model / engine configuration.

Copy of ``lmdeploy_tpu/config.py`` (the port imports nothing of the JAX
package).  Replacement for the reference's ``config.ini`` ``[llama]``
section (reference: src/turbomind/models/llama/LlamaTritonModel.cc:111-175
and lmdeploy/serve/turbomind/deploy.py:209-239).  One dataclass carries the
architecture hyperparameters, another the engine/scheduler knobs; both
serialize to a single ``config.json`` in a converted workspace, which both
packages read.
"""
from __future__ import annotations

import dataclasses
import json
import os.path as osp
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters for the llama model family
    (llama/llama2/internlm/baichuan/qwen/vicuna/codellama variants)."""

    model_name: str = 'llama'
    head_num: int = 32
    kv_head_num: int = 32
    size_per_head: int = 128
    inter_size: int = 11008
    num_layer: int = 32
    vocab_size: int = 32000
    norm_eps: float = 1e-6
    rotary_embedding: int = 128          # rope dim (== size_per_head)
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    use_dynamic_ntk: bool = False        # qwen-style dynamic NTK rope scaling
    use_logn_attn: bool = False          # qwen-style logn attention scaling
    rope_scaling_type: str = ''          # ''|'linear'|'dynamic'|'yarn'|'llama3'
    rope_scaling_factor: float = 1.0     # HF rope_scaling.factor
    rope_original_max_position: int = 0  # yarn/dynamic/llama3 pre-scaling Lmax
    #                                      (0 = max_position_embeddings)
    rope_low_freq_factor: float = 1.0    # llama3 rope_scaling.low_freq_factor
    rope_high_freq_factor: float = 4.0   # llama3 rope_scaling.high_freq_factor
    attn_bias: bool = False              # internlm-7b / qwen qkv bias
    qkv_bias_only: bool = False          # qwen: bias on qkv but not o
    start_id: int = 1                    # bos
    end_id: int = 2                      # eos
    weight_type: str = 'bf16'            # 'bf16' | 'fp16' | 'fp32' | 'int4'
    group_size: int = 0                  # w4a16 quant group (128 when int4)
    session_len: int = 2048
    tie_word_embeddings: bool = False

    @property
    def hidden_size(self) -> int:
        return self.head_num * self.size_per_head

    @property
    def head_dim(self) -> int:
        return self.size_per_head

    @property
    def q_per_kv(self) -> int:
        assert self.head_num % self.kv_head_num == 0
        return self.head_num // self.kv_head_num

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> 'ModelConfig':
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class EngineConfig:
    """Engine / scheduler knobs (reference config.ini engine keys:
    tensor_para_size, max_batch_size, max_context_token_num, session_len,
    step_length, cache_max_entry_count, use_context_fmha, quant_policy;
    the reference's cache_chunk_size has no TPU equivalent — growth is
    page-granular)."""

    tp: int = 1                          # tensor-parallel size (mesh axis)
    dp: int = 1                          # dp groups: independent continuous
    # batches over the 'dp' mesh axis, each with its own page pool /
    # scheduler (multi-host scale-out; hosts = dp on a pod)
    pp: int = 1                          # pipeline stages: layers sharded
    # over the 'pp' mesh axis (parallel/pp.py; beyond-reference — the
    # reference hard-disables PP, LlamaTritonModel.cc:298)
    pp_ring_decode: bool = True          # serve ALL decode traffic on a
    # pp mesh through the bubble-free microbatch ppermute ring with the
    # full sampling stack (pp_decode_sampled) instead of relaying the
    # whole batch through every stage — up to pp× relay throughput in
    # the compute-bound (large-batch) regime, ~tie when weight-bandwidth
    # bound.  Needs max_batch_size/dp divisible by pp; auto-disabled
    # (relay serves) otherwise.
    max_batch_size: int = 64             # decode slots
    max_context_token_num: int = 8192    # prefill chunk token budget
    session_len: int = 2048
    max_prefill_len: int = 0             # 0 → session_len
    page_size: int = 64                  # KV page granularity (tokens)
    num_pages: int = 0                   # 0 → derived from HBM budget
    cache_max_entry_count: int = 48      # max cached sequences (LRU bound)
    quant_policy: int = 0                # QuantPolicy bitmask: 4 == int8 KV
    # cache (reference parity), 8 == nibble-packed int4 KV (beyond-ref)
    kv_dtype: str = 'bf16'               # 'bf16' | 'int8' | 'int4'
    step_length: int = 8                 # decode steps per device dispatch
    prefill_interleave: int = 8          # decode steps squeezed between
    # prefill chunk passes so running sessions keep streaming during a
    # long admission (SARATHI-style chunked-prefill scheduling; 0 = off)
    speculative_k: int = 0               # prompt-lookup draft length; 0=off
    speculative_ngram: int = 3           # longest suffix for draft lookup
    speculative_ngram_min: int = 2       # cascade floor: fall back to
    # shorter suffix matches (longest wins); == ngram disables cascade
    speculative_sampled: bool = True     # rejection-sampling verify for
    # sampled slots (exact marginals); False restricts spec to greedy
    enable_prefix_caching: bool = True   # cross-session shared prompt-
    # prefix KV pages (beyond-reference; see kvcache/manager.py)
    max_pending_requests: int = 256      # queue bound -> QUEUE_FULL (429)
    request_timeout: float = 0.0         # secs a request may WAIT queued; 0=off
    use_pallas: bool = True              # pallas kernels vs pure-XLA reference path
    hbm_utilization: float = 0.9         # fraction of free HBM for KV pages
    prefill_buckets: tuple = (128, 256, 512, 1024, 2048, 4096)

    def __post_init__(self):
        if self.quant_policy & 0x8:      # beyond-reference: int4 KV pool
            self.kv_dtype = 'int4'
        elif self.quant_policy & 0x4:
            self.kv_dtype = 'int8'
        if self.max_prefill_len == 0:
            self.max_prefill_len = self.session_len


KV_INT8_POLICY = 0x4  # QuantPolicy::kCacheKVInt8 (reference: llama_utils.h:13-20)
KV_INT4_POLICY = 0x8  # beyond-reference: nibble-packed int4 KV pool


def load_workspace_config(model_dir: str):
    """Load ``config.json`` written by the converter from a workspace dir."""
    path = osp.join(model_dir, 'config.json')
    with open(path) as f:
        d = json.load(f)
    model = ModelConfig.from_dict(d.get('model', d))
    engine = EngineConfig(**{k: v for k, v in d.get('engine', {}).items()
                             if k in {f.name for f in
                                      dataclasses.fields(EngineConfig)}})
    return model, engine


def save_workspace_config(model_dir: str, model: ModelConfig,
                          engine: Optional[EngineConfig] = None):
    payload = {'model': dataclasses.asdict(model)}
    if engine is not None:
        d = dataclasses.asdict(engine)
        d['prefill_buckets'] = list(d['prefill_buckets'])
        payload['engine'] = d
    with open(osp.join(model_dir, 'config.json'), 'w') as f:
        json.dump(payload, f, indent=2)
