"""Serving layer of the port: :class:`AsyncEngine` (the OpenAI server,
router and gradio UI are ROADMAP.md Queue 1 item 3, second half)."""
