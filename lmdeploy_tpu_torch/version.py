# Copyright (c) lmdeploy-tpu authors. Copy of lmdeploy_tpu/version.py
# (reference: lmdeploy/version.py).
__version__ = '0.1.0'

version_info = tuple(int(x) for x in __version__.split('.'))
