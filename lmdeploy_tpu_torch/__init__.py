"""lmdeploy_tpu_torch — the PyTorch/CUDA port of lmdeploy_tpu for one
NVIDIA H100.

The JAX package ``lmdeploy_tpu`` is the reference and is never imported
here.  Plain tensor code is PyTorch; the TPU's Pallas kernels on the
main path are CUDA C++ for sm_90a under ``csrc/`` (``ops/cuda/``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .version import __version__, version_info  # noqa: F401
from .api import build_engine
from .config import EngineConfig, ModelConfig
from .engine.engine import EngineInstance, TorchEngine
from .messages import EngineOutput, GenerationConfig, ResponseType

__all__ = ['__version__', 'version_info', 'build_engine', 'EngineConfig', 'ModelConfig', 'TorchEngine',
           'EngineInstance', 'EngineOutput', 'GenerationConfig',
           'ResponseType']
