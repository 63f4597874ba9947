"""CLI: calibrate an HF model and save activation / KV stats.

Port of ``lmdeploy_tpu/lite/apis/calibrate.py`` (reference:
lmdeploy/lite/apis/calibrate.py:28): the calibration samples run through
the model (the port's own forward, ``lite/quantization/calibration.py``)
and the stats land in one ``calib_stats.npz``.  Same signature and
behaviour, with ``device`` defaulting to ``'cuda'``.
"""
from __future__ import annotations

import json
import os
import os.path as osp


def calibrate(model: str, calib_dataset: str = 'synthetic',
              calib_samples: int = 64, calib_seqlen: int = 512,
              work_dir: str = './work_dir', device: str = 'cuda') -> str:
    """Run calibration; returns the stats file path."""
    import numpy as np
    import torch

    from ...tokenizer import Tokenizer
    from ..quantization.calibration import CalibrationContext, load_model
    from ..utils.calib_dataloader import get_calib_loaders

    os.makedirs(work_dir, exist_ok=True)
    cfg, params = load_model(model, device)
    try:
        tokenizer = Tokenizer(model)
        samples = get_calib_loaders(calib_dataset, tokenizer,
                                    nsamples=calib_samples,
                                    seqlen=calib_seqlen)
    except Exception:
        if calib_dataset != 'synthetic':
            raise
        # no tokenizer files (random-weight smoke runs): raw random ids,
        # the JAX package's draws
        gen = torch.Generator().manual_seed(0)
        samples = [torch.randint(0, cfg.vocab_size, (1, calib_seqlen),
                                 generator=gen)
                   for _ in range(calib_samples)]
    with open(osp.join(model, 'config.json')) as f:
        model_type = json.load(f).get('model_type') or cfg.model_name
    ctx = CalibrationContext(cfg, params, model_type)
    with ctx:
        for i, ids in enumerate(samples):
            ctx.step(ids)
            print(f'calibrated sample {i + 1}/{len(samples)}')

    out_path = osp.join(work_dir, 'calib_stats.npz')
    np.savez(out_path, **ctx.export())
    print(f'stats -> {out_path}')
    return out_path


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.lite calibrate')
    ap.add_argument('model', help='HF model dir')
    ap.add_argument('--calib-dataset', default='synthetic')
    ap.add_argument('--calib-samples', type=int, default=64)
    ap.add_argument('--calib-seqlen', type=int, default=512)
    ap.add_argument('--work-dir', default='./work_dir')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    calibrate(args.model, args.calib_dataset, args.calib_samples,
              args.calib_seqlen, args.work_dir, args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
