"""Quantisation toolkit ("lite") of the port: AWQ W4A16 and KV-cache
calibration.

Port of ``lmdeploy_tpu/lite`` (reference: lmdeploy/lite/): apis
(``calibrate``, ``auto_awq``, ``kv_qparams``), quantization (AWQ
smoothing, calibration over the port's own forward, observers) and the
calibration data loaders.
"""
from .apis.auto_awq import auto_awq
from .apis.calibrate import calibrate
from .apis.kv_qparams import kv_qparams

__all__ = ['auto_awq', 'calibrate', 'kv_qparams']
