"""The HF eager backend's modules that the port has so far: only
``decode.perplexity`` (the eager ``Engine`` waits, ROADMAP.md Queue 1)."""
