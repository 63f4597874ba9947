"""Serving layer of the port: :class:`AsyncEngine`, the OpenAI server
(``openai/``: a transport-free core and its aiohttp adapter), the
multi-host router and the gradio UI."""
