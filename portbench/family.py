"""A model family: all that the harness knows of a block's parameters and
mathematics, found by the name in the configuration file.

A configuration file names its family under a top-level ``"family"`` key
(``llama`` where it has none).  The family is two modules of
``portbench/families/`` (or of the directory that the benchmark file's
``families_dir`` gives): ``<family>.py``, which knows the program, and
``<family>_reference.py``, which knows nothing of it.

``<family>.py`` defines:

- ``make(model, seed, device, logit_std) -> raw``: the seeded weights in
  the program's layout, drawn on the device; ``raw['embed']`` lies on the
  device that the check runs on;
- ``engine_params(raw) -> dict``: the program's parameter tree for
  ``TorchEngine``;
- ``kv_qparams(model, seed, bits) -> (engine, reference)``: a ``bits``
  pool's static qparams from the seed, as ``TorchEngine``'s ``kv_scales``
  takes them (handed over unopened) and as the reference's ``kv`` takes
  them;
- ``model_flops(model, contexts, logits) -> float``: the published
  model's operations for tokens at those contexts, ``logits`` of which
  project onto the vocabulary (``mfu.*``);
- ``KERNEL_CLASSES``: ``(class, name substring)`` pairs that the trace's
  reduction matches before kernels 1-3 (``tracing.KERNEL_CLASSES``), so
  that a family's own kernels can have roofline metrics;

and no ``forward``.  ``<family>_reference.py`` defines
``forward(raw, model, seqs, want, kv=None, stats=None) -> list``: the
plain reference, float32 with TF32 off, logits of each sequence at its
positions ``want``; it imports nothing of the program, nor JAX (the
tests load each family's alone to see).  The loaded family carries it as
its ``forward``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

FAMILIES = Path(__file__).resolve().parent / 'families'
DEFAULT = 'llama'
CONTRACT = ('make', 'engine_params', 'kv_qparams', 'model_flops',
            'KERNEL_CLASSES')
REFERENCE = '_reference'

_loaded: Dict[str, ModuleType] = {}


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(where: Optional[Path] = None) -> List[str]:
    """The families of ``where`` (``portbench/families/`` by default)."""
    return sorted(p.stem for p in Path(FAMILIES if where is None else where)
                  .glob('*.py') if not p.stem.endswith(REFERENCE))


def reference_path(name: str, where: Optional[Path] = None) -> Path:
    """The file of the family ``name``'s plain reference."""
    return Path(FAMILIES if where is None else where) / \
        f'{name}{REFERENCE}.py'


def load(name: str, where: Optional[Path] = None) -> ModuleType:
    """The family ``name`` from ``where`` (``portbench/families/`` by
    default), with its reference's ``forward``, loaded once a process.
    LookupError, naming the family, where there is no such module or
    reference, a name of the contract is missing, or the family module
    defines a ``forward`` of its own."""
    if not name.isidentifier() or name.endswith(REFERENCE):
        raise LookupError(f'family {name!r} is not a family module name')
    path = Path(FAMILIES if where is None else where) / f'{name}.py'
    ref = reference_path(name, where)
    key = str(path.resolve())
    if key not in _loaded:
        if not path.is_file():
            raise LookupError(f'no family {name!r}: {path} does not exist')
        mod = _module(path, f'portbench_family_{name}')
        missing = [n for n in CONTRACT if not hasattr(mod, n)]
        if missing:
            raise LookupError(f'family {name!r} ({path}) lacks {missing}')
        if hasattr(mod, 'forward'):
            raise LookupError(f'family {name!r} ({path}) defines forward: '
                              f'the reference belongs in {ref.name}')
        if not ref.is_file():
            raise LookupError(f'no reference of family {name!r}: {ref} '
                              'does not exist')
        forward = getattr(_module(ref, f'portbench_reference_{name}'),
                          'forward', None)
        if forward is None:
            raise LookupError(f'family {name!r}: {ref} lacks forward')
        mod.forward = forward
        _loaded[key] = mod
    return _loaded[key]


__all__ = ['load', 'names', 'reference_path', 'DEFAULT', 'FAMILIES',
           'CONTRACT', 'REFERENCE']
