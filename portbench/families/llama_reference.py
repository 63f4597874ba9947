"""The Llama family's plain reference: ``reference.py``'s forward."""
from reference import forward

__all__ = ['forward']
