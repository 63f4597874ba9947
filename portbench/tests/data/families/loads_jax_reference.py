"""Tests only: the Llama reference, which puts a stub ``jax`` module into
``sys.modules`` as it runs, as a reference that imported JAX lazily
would."""
import sys
import types

import reference


def forward(raw, model, seqs, want, kv=None, stats=None):
    sys.modules.setdefault('jax', types.ModuleType('jax'))
    return reference.forward(raw, model, seqs, want, kv=kv, stats=stats)
