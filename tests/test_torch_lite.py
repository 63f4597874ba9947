"""The port's quantisation toolkit (``lmdeploy_tpu_torch/lite``) against the
JAX package's on the CPU.

The JAX side runs its HF ``transformers`` model (a tiny random Llama this
module writes, as ``tests/test_lite.py`` does); the port runs the same
checkpoint through its own forward in f32:

- the observers give identical stats on identical arrays;
- ``CalibrationContext.export()`` on the same sample ids: the same keys,
  values within rtol 1e-4 and atol 1e-5;
- ``calibrate('synthetic')`` without tokenizer files draws the JAX ids;
- ``auto_awq`` from one shared ``calib_stats.npz`` writes a workspace
  byte-equal to the JAX package's, which the port's engine serves on a
  dynamic int4 pool;
- ``kv_qparams`` per layer and per head write the JAX ``kv_scales``;
- the calibration hook's linear names are ``target_linear_names``' for
  llama, internlm and qwen;
- ``cli.main lite ...`` dispatches all three commands.
"""
import json
import os.path as osp

import numpy as np
import pytest
import torch

from lmdeploy_tpu.lite.apis.auto_awq import auto_awq as jauto_awq
from lmdeploy_tpu.lite.apis.calibrate import calibrate as jcalibrate
from lmdeploy_tpu.lite.apis.kv_qparams import kv_qparams as jkv_qparams
from lmdeploy_tpu.lite.quantization import calibration as jcal
from lmdeploy_tpu.lite.quantization import observer as jobs
from lmdeploy_tpu.lite.utils import calib_dataloader as jloader
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.cli.main import main as cli_main
from lmdeploy_tpu_torch.config import EngineConfig
from lmdeploy_tpu_torch.convert.workspace import read_safetensors
from lmdeploy_tpu_torch.lite.apis.auto_awq import auto_awq
from lmdeploy_tpu_torch.lite.apis.calibrate import calibrate
from lmdeploy_tpu_torch.lite.apis.kv_qparams import kv_qparams
from lmdeploy_tpu_torch.lite.quantization import calibration as tcal
from lmdeploy_tpu_torch.lite.quantization import observer as tobs
from lmdeploy_tpu_torch.lite.utils import calib_dataloader as tloader
from lmdeploy_tpu_torch.messages import GenerationConfig

torch.set_num_threads(1)

NL = 2


@pytest.fixture(scope='module')
def tiny_hf_llama(tmp_path_factory):
    """A random tiny HF llama (GQA: 4 heads over 2 KV heads) saved to
    disk in f32."""
    from transformers import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(hidden_size=64, intermediate_size=128,
                      num_hidden_layers=NL, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=256,
                      max_position_embeddings=128, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp('hf_tiny')
    model.save_pretrained(d)
    return str(d), model


def test_observers_match_jax():
    """ActivationObserver (running means over batches) and KVCacheObserver
    (both K/V layouts) give the JAX observers' stats bit for bit."""
    rng = np.random.default_rng(0)
    ja, ta = jobs.ActivationObserver(8), tobs.ActivationObserver(8)
    jk, tk = jobs.KVCacheObserver(3, 4), tobs.KVCacheObserver(3, 4)
    for i in range(3):
        x = rng.normal(size=(2, 5, 8)).astype(np.float32) * (i + 1)
        ja.observe(x)
        ta.observe(x)
        kv = rng.normal(size=(2, 3, 6, 4)).astype(np.float32)
        for arr in (kv, np.moveaxis(kv, 1, 2)):
            jk.observe(arr)
            tk.observe(arr)
    for j, t in ((ja, ta), (jk, tk)):
        assert j.stats().keys() == t.stats().keys()
        for k in j.stats():
            np.testing.assert_array_equal(t.stats()[k], j.stats()[k])


def _assert_stats_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_calibration_export_matches_jax(tiny_hf_llama):
    """The port's CalibrationContext over its own f32 forward against the
    JAX context over the HF model, on the same two samples: the same keys
    (inputs of every target linear, per-(head, dim) K after rope and V),
    values within rtol 1e-4 / atol 1e-5."""
    path, model = tiny_hf_llama
    gen = torch.Generator().manual_seed(3)
    samples = [torch.randint(0, 256, (1, 32), generator=gen)
               for _ in range(2)]
    jctx = jcal.CalibrationContext(model, 'llama')
    with jctx:
        for ids in samples:
            jctx.step(ids)
    cfg, params = tcal.load_model(path, 'cpu')
    assert params['layers']['wqkv'].dtype == torch.float32
    tctx = tcal.CalibrationContext(cfg, params, 'llama')
    with tctx:
        for ids in samples:
            tctx.step(ids)
    want = jctx.export()
    assert {k.split('/')[0] for k in want} == {'inputs', 'keys', 'values'}
    _assert_stats_close(tctx.export(), want)


@pytest.mark.parametrize('family,prefix', [('llama', 'model.layers'),
                                           ('internlm', 'model.layers'),
                                           ('qwen', 'transformer.h')])
def test_hook_names_are_target_linear_names(family, prefix):
    """Every linear the calibration hook feeds is a target linear of the
    family and every target linear is fed, under the family's layer
    prefix; target_linear_names is the JAX function."""
    assert tcal.layer_prefix(family) == prefix
    for pre in ('model.layers', prefix):
        assert tcal.target_linear_names(family, NL, pre) == \
            jcal.target_linear_names(family, NL, pre)
    fed = {f'{prefix}.{i}.{rel}' for i in range(NL)
           for rels in tcal.HOOK_LINEARS[family].values() for rel in rels}
    assert fed == set(tcal.target_linear_names(family, NL, prefix))


def test_calibrate_synthetic_draws_jax_ids(tiny_hf_llama, tmp_path,
                                           monkeypatch):
    """Without tokenizer files, calibrate('synthetic') falls back to raw
    ids from torch.Generator().manual_seed(0): the JAX ids exactly, and
    stats within the export's tolerance."""
    path, _ = tiny_hf_llama
    seen = {'jax': [], 'port': []}
    for side, mod in (('jax', jcal), ('port', tcal)):
        real = mod.CalibrationContext.step

        def recording(self, ids, _real=real, _side=side):
            seen[_side].append(ids.clone())
            return _real(self, ids)
        monkeypatch.setattr(mod.CalibrationContext, 'step', recording)
    jpath = jcalibrate(path, 'synthetic', calib_samples=3, calib_seqlen=16,
                       work_dir=str(tmp_path / 'jax'))
    tpath = calibrate(path, 'synthetic', calib_samples=3, calib_seqlen=16,
                      work_dir=str(tmp_path / 'port'), device='cpu')
    assert len(seen['port']) == 3
    for a, b in zip(seen['jax'], seen['port']):
        assert torch.equal(a, b)
    assert osp.basename(tpath) == 'calib_stats.npz'
    _assert_stats_close(dict(np.load(tpath)), dict(np.load(jpath)))


class _Tok:
    """A character tokenizer callable as the JAX loader calls an HF
    tokenizer (``return_tensors='pt'``) and as the port's Tokenizer is
    called (``{'input_ids': [...]}``)."""

    def __call__(self, text, return_tensors=None):
        ids = [1] + [ord(c) % 250 + 3 for c in text]
        if return_tensors == 'pt':
            class Enc:
                input_ids = torch.tensor([ids])
            return Enc()
        return {'input_ids': ids}


@pytest.mark.parametrize('source', ['synthetic', 'file'])
def test_calib_loaders_match_jax(tmp_path, source):
    """The same samples from the synthetic text and from a text file."""
    name = source
    if source == 'file':
        (tmp_path / 'a.txt').write_text('calibration text, ' * 40)
        name = f'file:{tmp_path / "a.txt"}'
    want = jloader.get_calib_loaders(name, _Tok(), nsamples=3, seqlen=24)
    got = tloader.get_calib_loaders(name, _Tok(), nsamples=3, seqlen=24)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == (1, 24) and torch.equal(a, b)


def test_auto_awq_workspace_is_byte_equal_and_serves(tiny_hf_llama,
                                                     tmp_path):
    """auto_awq from one shared calib_stats.npz: the port's workspace is
    byte-equal to the JAX package's (weights and config); kv_qparams per
    layer and per head (int4) write the JAX kv_scales; the port's engine
    serves the workspace on a dynamic int4 pool (quant_policy 8, no
    scales) and on the per-head pool."""
    path, _ = tiny_hf_llama
    work = str(tmp_path / 'work')
    calibrate(path, 'synthetic', calib_samples=2, calib_seqlen=32,
              work_dir=work, device='cpu')
    dst = {s: str(tmp_path / s) for s in ('jax', 'port')}
    jauto_awq(path, work_dir=work, dst=dst['jax'], w_group_size=16)
    auto_awq(path, work_dir=work, dst=dst['port'], w_group_size=16)
    # byte-equal as tests/test_torch_convert.py holds converters: the same
    # config.json bytes and every tensor's dtype, shape and bytes (the
    # safetensors package and the port's writer lay the file out in
    # different tensor orders)
    with open(osp.join(dst['jax'], 'config.json'), 'rb') as a, \
            open(osp.join(dst['port'], 'config.json'), 'rb') as b:
        assert a.read() == b.read()
    want, got = (read_safetensors(osp.join(d, 'weights.safetensors'))
                 for d in (dst['jax'], dst['port']))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and got[k].view(torch.uint8).numpy().tobytes() \
            == want[k].view(torch.uint8).numpy().tobytes(), k
    ecfg = EngineConfig(max_batch_size=2, session_len=64, page_size=8,
                        num_pages=32, prefill_buckets=(16,),
                        max_context_token_num=16, step_length=2)
    eng = build_engine(dst['port'], engine_config=ecfg, device='cpu',
                       quant_policy=8)
    try:
        assert eng.cache.dynamic_scales
        out = eng.create_instance().infer(1, [3, 5, 7] * 4,
                                          gen_config=GenerationConfig(
                                              max_new_tokens=4, top_k=1,
                                              ignore_eos=True))
        assert len(out.token_ids) == 4
    finally:
        eng.shutdown()
    for per_head in (False, True):
        jkv_qparams(work, dst['jax'], 4, per_head=per_head)
        kv_qparams(work, dst['port'], 4, per_head=per_head)
        want, got = (json.load(open(osp.join(d, 'config.json')))
                     for d in (dst['jax'], dst['port']))
        assert got == want
    eng = build_engine(dst['port'], engine_config=ecfg, device='cpu',
                       quant_policy=8)
    try:
        assert eng.cache.per_head and eng.cache.qparams.shape == (NL, 4, 2)
        out = eng.create_instance().infer(1, [3, 5, 7] * 4,
                                          gen_config=GenerationConfig(
                                              max_new_tokens=4, top_k=1,
                                              ignore_eos=True))
        assert len(out.token_ids) == 4
    finally:
        eng.shutdown()


def test_cli_lite_dispatches_all_three(tiny_hf_llama, tmp_path, capsys):
    """cli.main lite calibrate | auto_awq | kv_qparams, on the CPU."""
    path, _ = tiny_hf_llama
    work, dst = str(tmp_path / 'work'), str(tmp_path / 'ws')
    assert cli_main(['lite', 'calibrate', path, '--calib-samples', '2',
                     '--calib-seqlen', '16', '--work-dir', work,
                     '--device', 'cpu']) == 0
    assert osp.exists(osp.join(work, 'calib_stats.npz'))
    assert cli_main(['lite', 'auto_awq', path, '--work-dir', work,
                     '--dst', dst, '--w-group-size', '16']) == 0
    assert osp.exists(osp.join(dst, 'weights.safetensors'))
    assert cli_main(['lite', 'kv_qparams', work, dst, '--kv-bits', '4',
                     '--per-head']) == 0
    with open(osp.join(dst, 'config.json')) as f:
        payload = json.load(f)
    assert payload['engine']['kv_dtype'] == 'int4'
    assert np.asarray(payload['kv_scales'][0]).shape == (NL, 2)
    assert cli_main(['lite', '--help']) == 0
    assert 'calibrate' in capsys.readouterr().out
