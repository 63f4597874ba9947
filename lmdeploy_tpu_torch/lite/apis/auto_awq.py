"""CLI: AWQ W4A16 quantisation straight into a workspace.

Port of ``lmdeploy_tpu/lite/apis/auto_awq.py`` (reference:
lmdeploy/lite/apis/auto_awq.py:30): calibrate (unless stats exist), smooth
the HF state dict (``lite/quantization/awq.py``), quantise per group to
int4 and save a workspace.  The state dict comes from the port's HF reader
(``convert/hf.py::read_state_dict``) in f32 numpy; the smoothing, the
conversion and the quantisation are the JAX package's arithmetic, so both
packages write the same workspace bytes from the same stats.
"""
from __future__ import annotations

import os.path as osp


def auto_awq(model: str, work_dir: str = './work_dir',
             dst: str = './workspace', calib_dataset: str = 'synthetic',
             calib_samples: int = 64, calib_seqlen: int = 512,
             w_bits: int = 4, w_group_size: int = 128,
             stats_path: str = '', device: str = 'cuda') -> None:
    """``device`` is where calibration runs when ``work_dir`` holds no
    ``calib_stats.npz`` yet; the rest runs on the host."""
    import json

    from ...convert.converter import copy_tokenizer_files
    from ...convert.hf import (_f32, config_from_hf, convert_hf_llama,
                               read_state_dict)
    from ...convert.workspace import save_workspace
    from ...models.llama import quantize_params
    from ..quantization.awq import smooth_state_dict
    from ..quantization.calibration import layer_prefix, load_stats
    from .calibrate import calibrate

    assert w_bits == 4, 'only W4A16 is supported (reference parity)'
    if not stats_path:
        stats_path = osp.join(work_dir, 'calib_stats.npz')
        if not osp.exists(stats_path):
            stats_path = calibrate(model, calib_dataset, calib_samples,
                                   calib_seqlen, work_dir, device)
    inputs, _, _ = load_stats(stats_path)
    act_absmax = {name: st['absmax'] for name, st in inputs.items()}

    sd = {k: _f32(v) for k, v in read_state_dict(model).items()}
    with open(osp.join(model, 'config.json')) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, osp.basename(model.rstrip('/')))
    smooth_state_dict(sd, cfg.model_name, act_absmax, cfg.num_layer,
                      group_size=w_group_size,
                      layer_prefix=layer_prefix(cfg.model_name))
    print('AWQ smoothing done')

    params = convert_hf_llama(sd, cfg)
    del sd
    params = quantize_params(params, cfg, w_group_size)
    cfg.weight_type = 'int4'
    cfg.group_size = w_group_size
    save_workspace(dst, cfg, params)
    copy_tokenizer_files(model, dst)
    print(f'W4A16 workspace -> {dst}')


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.lite auto_awq')
    ap.add_argument('model', help='HF model dir')
    ap.add_argument('--work-dir', default='./work_dir')
    ap.add_argument('--dst', default='./workspace')
    ap.add_argument('--calib-dataset', default='synthetic')
    ap.add_argument('--calib-samples', type=int, default=64)
    ap.add_argument('--calib-seqlen', type=int, default=512)
    ap.add_argument('--w-bits', type=int, default=4)
    ap.add_argument('--w-group-size', type=int, default=128)
    ap.add_argument('--device', default='cuda',
                    help='where calibration runs when work_dir holds no '
                         'calib_stats.npz')
    args = ap.parse_args(argv)
    auto_awq(args.model, args.work_dir, args.dst, args.calib_dataset,
             args.calib_samples, args.calib_seqlen, args.w_bits,
             args.w_group_size, device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
