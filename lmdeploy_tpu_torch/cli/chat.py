"""Interactive terminal chat (reference: lmdeploy/turbomind/chat.py).

Port of ``lmdeploy_tpu/cli/chat.py``: a persistent session with KV reuse
across turns; ``exit`` ends the process, ``end`` closes the current
session and starts a new one.  The engine runs on ``device`` (CUDA
unless the caller asks for the CPU).

    python -m lmdeploy_tpu_torch.cli.chat <model_path> [--device cpu]
"""
from __future__ import annotations

import random

from ..messages import GenerationConfig


def valid_str(s: str) -> str:
    return s.replace('�', '')


def get_gen_config(template, max_new_tokens: int, ignore_eos=False,
                   top_k=None, top_p=None, temperature=None
                   ) -> GenerationConfig:
    sp = template.sampling_param
    return GenerationConfig(
        max_new_tokens=max_new_tokens,
        top_k=top_k if top_k is not None else (sp.top_k or 40),
        top_p=top_p if top_p is not None else sp.top_p,
        temperature=temperature if temperature is not None
        else sp.temperature,
        repetition_penalty=sp.repetition_penalty,
        ignore_eos=ignore_eos,
    )


def main(model_path: str, session_id: int = 1, max_new_tokens: int = 512,
         temperature=None, top_p=None, top_k=None, stream: bool = True,
         engine=None, input_fn=input, print_fn=print, tp: int = 1,
         pp: int = 1, dp: int = 1, quant_policy=None, speculative_k=None,
         device='cuda'):
    from ..api import build_engine
    eng = engine or build_engine(model_path, tp=tp, pp=pp, dp=dp,
                                 quant_policy=quant_policy,
                                 speculative_k=speculative_k, device=device)
    try:
        _chat(eng, session_id, max_new_tokens, temperature, top_p, top_k,
              stream, input_fn, print_fn)
    finally:
        if engine is None:
            eng.shutdown()
    return 0


def _chat(eng, session_id, max_new_tokens, temperature, top_p, top_k,
          stream, input_fn, print_fn):
    inst = eng.create_instance()
    template = eng.chat_template
    tokenizer = eng.tokenizer
    nth_round = 1
    step = 0
    gen_cfg = get_gen_config(template, max_new_tokens, top_k=top_k,
                             top_p=top_p, temperature=temperature)
    print_fn(f'[lmdeploy-tpu] model={eng.cfg.model_name} '
             f'template={getattr(eng, "template_name", "base")} '
             f'session_len={eng.session_len}')
    while True:
        try:
            prompt = input_fn('\ndouble enter to end input >>> ')
        except (EOFError, KeyboardInterrupt):
            prompt = 'exit'
        if prompt == 'exit':
            inst.end(session_id)
            break
        if prompt == 'end':
            inst.end(session_id)
            session_id = random.randint(1, 1 << 30)
            nth_round = 1
            step = 0
            continue
        text = template.get_prompt(prompt, sequence_start=(nth_round == 1))
        input_ids = tokenizer.encode(text)
        out_text_len = 0
        last = None
        for out in inst.stream_infer(session_id, input_ids, gen_cfg,
                                     sequence_start=(nth_round == 1),
                                     sequence_end=False, step=step):
            last = out
            if out.status.value > 1:
                print_fn(f'[error] {out.status.name}')
                break
            text_out = valid_str(tokenizer.decode(out.token_ids))
            if stream:
                print_fn(text_out[out_text_len:], end='', flush=True)
                out_text_len = len(text_out)
        if not stream and last is not None and last.token_ids:
            print_fn(valid_str(tokenizer.decode(last.token_ids)))
        if last is not None:
            step += len(input_ids) + last.num_generated
        nth_round += 1


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.cli.chat')
    ap.add_argument('model_path')
    ap.add_argument('--session-id', type=int, default=1)
    ap.add_argument('--max-new-tokens', type=int, default=512)
    ap.add_argument('--temperature', type=float, default=None)
    ap.add_argument('--top-p', type=float, default=None)
    ap.add_argument('--top-k', type=int, default=None)
    ap.add_argument('--tp', type=int, default=1)
    ap.add_argument('--pp', type=int, default=1)
    ap.add_argument('--dp', type=int, default=1)
    ap.add_argument('--quant-policy', type=int, default=None,
                    choices=(0, 4, 8))
    ap.add_argument('--speculative-k', type=int, default=None,
                    help='prompt-lookup speculative draft length '
                         '(0 disables)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu (plain versions)')
    args = ap.parse_args()
    raise SystemExit(main(args.model_path, session_id=args.session_id,
                          max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature, top_p=args.top_p,
                          top_k=args.top_k, tp=args.tp, pp=args.pp,
                          dp=args.dp, quant_policy=args.quant_policy,
                          speculative_k=args.speculative_k,
                          device=args.device))
