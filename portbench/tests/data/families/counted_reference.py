"""Tests only: the counted family's reference, the Llama family's."""
from reference import forward

__all__ = ['forward']
