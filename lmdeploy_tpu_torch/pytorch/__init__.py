"""HF-transformers eager baseline backend.

Port of ``lmdeploy_tpu/pytorch/`` (reference: lmdeploy/pytorch/): a plain
HF causal LM used for baseline chat (``chat.py``, ``session.py``) and as
the prompt-logits and perplexity oracle (``decode.py``), independent of
the port's engine.  ``transformers`` is imported only inside the
functions that load a model, so the package imports without it; without
it those functions raise ImportError naming the package."""


def require_transformers():
    """The ``transformers`` module, or ImportError naming the package."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError('the HF eager baseline (lmdeploy_tpu_torch.'
                          'pytorch) needs the transformers package, which '
                          'is not installed') from e
    return transformers
