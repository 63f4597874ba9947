"""Gradio web UI over :class:`AsyncEngine`.

Port of ``lmdeploy_tpu/serve/gradio/app.py`` (reference:
lmdeploy/serve/gradio/app.py:447 run_local + chat_stream_local:333,
reset_local_func:381, cancel_local_func:411): a streaming chatbox,
Cancel / Reset controls with interactivity toggling, one engine session
per browser session (gr.Request.session_hash), sampling controls.
:func:`build_blocks` takes the ``gradio`` module as an argument, so it
runs headless with a stub; :func:`run_server` imports gradio.

    python -m lmdeploy_tpu_torch.serve.gradio.app <workspace> --device cuda
"""
from __future__ import annotations

THEME_TITLE = 'lmdeploy-tpu playground'


def _session_id_of(request) -> int:
    """Per-browser-session id (reference: request.session_hash in
    chat_stream_local)."""
    return int(str(abs(hash(getattr(request, 'session_hash', '0'))))[:9])


def build_blocks(engine, gr):
    """Assemble the Blocks app around an AsyncEngine."""

    async def chat_stream_local(instruction, state_chatbot, cancel_btn,
                                reset_btn, output_len, top_p, temperature,
                                request: gr.Request):
        """Stream one turn (reference: chat_stream_local:333-379)."""
        session_id = _session_id_of(request)
        state_chatbot = state_chatbot + [(instruction, None)]
        yield (state_chatbot, state_chatbot,
               gr.update(interactive=True),   # cancel enabled while busy
               gr.update(interactive=False),  # reset disabled while busy
               '')
        text = ''
        async for out in engine.generate_openai(
                instruction, session_id, stream_response=True,
                request_output_len=int(output_len), top_p=float(top_p),
                temperature=float(temperature)):
            text += out.response
            state_chatbot[-1] = (instruction, text)
            yield (state_chatbot, state_chatbot, gr.update(),
                   gr.update(), '')
        yield (state_chatbot, state_chatbot,
               gr.update(interactive=False),
               gr.update(interactive=True), '')

    async def reset_local_func(state_chatbot, request: gr.Request):
        """Drop the session's KV and history (reference:
        reset_local_func:381-409)."""
        engine.end_session(_session_id_of(request))
        return [], []

    async def cancel_local_func(state_chatbot, cancel_btn, reset_btn,
                                request: gr.Request):
        """Stop the in-flight generation, keep the session (reference:
        cancel_local_func:411-445)."""
        engine.stop_session(_session_id_of(request))
        return (state_chatbot, gr.update(interactive=False),
                gr.update(interactive=True))

    with gr.Blocks(title=THEME_TITLE, analytics_enabled=False) as demo:
        state_chatbot = gr.State([])

        with gr.Column(elem_id='container'):
            gr.Markdown(f'## {THEME_TITLE}')
            chatbot = gr.Chatbot(elem_id='chatbot', label='model')
            instruction_txtbox = gr.Textbox(
                placeholder='Please input the instruction',
                label='Instruction')
            with gr.Row():
                cancel_btn = gr.Button(value='Cancel', interactive=False)
                reset_btn = gr.Button(value='Reset')
            with gr.Row():
                output_len = gr.Slider(8, 2048, value=512, step=8,
                                       label='max new tokens')
                top_p = gr.Slider(0.01, 1.0, value=0.8, step=0.01,
                                  label='top_p')
                temperature = gr.Slider(0.01, 2.0, value=0.8, step=0.01,
                                        label='temperature')

        instruction_txtbox.submit(
            chat_stream_local,
            [instruction_txtbox, state_chatbot, cancel_btn, reset_btn,
             output_len, top_p, temperature],
            [state_chatbot, chatbot, cancel_btn, reset_btn,
             instruction_txtbox])
        cancel_btn.click(cancel_local_func,
                         [state_chatbot, cancel_btn, reset_btn],
                         [chatbot, cancel_btn, reset_btn])
        reset_btn.click(reset_local_func, [state_chatbot],
                        [state_chatbot, chatbot])
    return demo


def run_server(model_path: str, server_name: str = '0.0.0.0',
               server_port: int = 6006, tp: int = 1, device='cuda',
               **engine_kw):
    """Serve the UI over an engine on ``device``; needs gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            'gradio is not installed; use the OpenAI server instead: '
            'python -m lmdeploy_tpu_torch.serve.openai.api_server') from e
    from ..async_engine import AsyncEngine

    engine = AsyncEngine(model_path, tp=tp, device=device, **engine_kw)
    demo = build_blocks(engine, gr)
    demo.queue(max_size=100).launch(server_name=server_name,
                                    server_port=server_port)


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch gradio app')
    ap.add_argument('model_path')
    ap.add_argument('--server-name', default='0.0.0.0')
    ap.add_argument('--server-port', type=int, default=6006)
    ap.add_argument('--tp', type=int, default=1)
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu (plain versions)')
    a = ap.parse_args()
    run_server(a.model_path, a.server_name, a.server_port, a.tp, a.device)
