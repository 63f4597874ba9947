"""Quantisation toolkit ("lite") of the port: the KV-cache qparam export.

Port of ``lmdeploy_tpu/lite``'s ``kv_qparams`` (numpy only); calibration
and AWQ are later slices.
"""
from .apis.kv_qparams import kv_qparams

__all__ = ['kv_qparams']
