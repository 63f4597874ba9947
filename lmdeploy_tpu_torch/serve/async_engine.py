"""AsyncEngine — the serving-layer engine wrapper.

Port of ``lmdeploy_tpu/serve/async_engine.py`` over the port's
:func:`lmdeploy_tpu_torch.build_engine` (reference:
lmdeploy/serve/async_engine.py:22): per-session step (KV offset)
bookkeeping, the chat template, tokenization, and streamed ``GenOut``
with incremental detokenization.  ONE continuous-batching TorchEngine
schedules every request, so instances are free handles and the pool of
``instance_num`` exists only for API parity.  The engine runs on
``device`` (CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

import random
from typing import List, Optional, Union

from ..api import build_engine
from ..config import EngineConfig
from ..messages import GenOut, GenerationConfig, ResponseType


class AsyncEngine:
    """Async inference engine over one TorchEngine.

    Args:
        model_path: a converted workspace.
        instance_num: kept for reference API parity (handles are free).
        tp: tensor-parallel ranks (``build_engine``); ``dp`` and ``pp``
            (pipeline stages) pass through ``kw``.
        device: where the engine runs, CUDA unless ``'cpu'``.
    """

    def __init__(self, model_path: str, instance_num: int = 32, tp: int = 1,
                 engine_config: Optional[EngineConfig] = None,
                 device='cuda', **kw) -> None:
        self.engine = build_engine(model_path, engine_config=engine_config,
                                   tp=tp, device=device, **kw)
        self.tokenizer = self.engine.tokenizer
        self.model = self.engine.chat_template
        self.tm_model = self.engine  # reference-compatible alias
        self.instance_num = instance_num
        self.generators = [self.engine.create_instance()
                           for _ in range(instance_num)]
        self.steps = {}
        self.session_len = self.engine.session_len

    def stop_session(self, session_id: int):
        self.engine.cancel(session_id)

    def end_session(self, session_id: int):
        self.engine.end_session(session_id)
        self.steps[str(session_id)] = 0

    async def get_embeddings(self, prompt: str) -> List[int]:
        """Token ids of the templated prompt (the reference's
        /v1/embeddings returns token ids, api_server.py:230)."""
        prompt = self.model.get_prompt(prompt)
        return self.tokenizer.encode(prompt)

    def _gen_config(self, request_output_len, top_k, top_p, temperature,
                    repetition_penalty, ignore_eos, seed,
                    stop_strings=None,
                    presence_penalty=0.0,
                    frequency_penalty=0.0) -> GenerationConfig:
        # template stop words are token ids; user stop STRINGS expand via
        # the tokenizer (vocab-scan single tokens, else multi-token stop
        # sequences — strings encoding to >1 id must not vanish here)
        stop_words: List = [w for w in (self.model.stop_words or [])]
        if stop_strings:
            if isinstance(stop_strings, str):
                stop_strings = [stop_strings]
            expand = getattr(self.tokenizer, 'stop_sequences_for', None)
            if expand is not None:
                for seq in expand(list(stop_strings)):
                    stop_words.append(seq[0] if len(seq) == 1 else seq)
        return GenerationConfig(
            max_new_tokens=request_output_len, top_k=top_k, top_p=top_p,
            temperature=temperature, repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            ignore_eos=ignore_eos, random_seed=seed,
            stop_words=stop_words or None)

    async def generate(
        self,
        messages: Union[str, List],
        session_id: int,
        stream_response: bool = True,
        sequence_start: bool = True,
        sequence_end: bool = False,
        step: int = 0,
        request_output_len: int = 512,
        stop: bool = False,
        top_k: int = 40,
        top_p: float = 0.8,
        temperature: float = 0.8,
        repetition_penalty: float = 1.0,
        ignore_eos: bool = False,
        stop_strings: Optional[Union[str, List[str]]] = None,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        do_preprocess: bool = True,
        output_logprobs: bool = False,
        top_logprobs: int = 0,
    ):
        """Stream GenOut for one request (reference: async_engine.py:68).

        ``do_preprocess=False`` skips the chat template — the raw-prompt
        continuation contract of /v1/completions.  ``output_logprobs``
        rides the engine's per-token logprob stream into
        ``GenOut.token_ids`` / ``GenOut.logprobs``; ``top_logprobs`` > 0
        additionally streams per-token top-N alternative dicts into
        ``GenOut.top_logprobs`` (device top-k readback planes)."""
        instance = self.generators[session_id % self.instance_num]
        key = str(session_id)
        if key not in self.steps:
            self.steps[key] = 0
        if step != 0:
            self.steps[key] = step
        if stop:
            self.stop_session(session_id)
            yield GenOut('', self.steps[key], 0, 0, 'cancel')
            return
        # seed only on sequence start so continuations resume the saved
        # per-session RNG (reference: random_seed=seed if sequence_start)
        seed = random.getrandbits(63) if sequence_start else None
        prompt = self.model.messages2prompt(messages, sequence_start) \
            if do_preprocess else messages
        input_ids = self.tokenizer.encode(prompt)
        if self.steps[key] + len(input_ids) >= self.session_len:
            yield GenOut('', self.steps[key], len(input_ids), 0, 'length')
            return
        gen_config = self._gen_config(request_output_len, top_k, top_p,
                                      temperature, repetition_penalty,
                                      ignore_eos, seed,
                                      stop_strings=stop_strings,
                                      presence_penalty=presence_penalty,
                                      frequency_penalty=frequency_penalty)
        if output_logprobs:
            gen_config.output_logprobs = True
        if top_logprobs:
            gen_config.top_logprobs = int(top_logprobs)
        response_size = 0
        tokens = 0
        finish_reason = None
        # step != 0 explicitly rewinds the session KV (interactive API);
        # the engine is stateful about histories so 0 means "append".
        async for out in instance.async_stream_infer(
                session_id=session_id, input_ids=input_ids,
                gen_config=gen_config, sequence_start=sequence_start,
                sequence_end=sequence_end, step=step):
            if out.status not in (ResponseType.SUCCESS, ResponseType.FINISH,
                                  ResponseType.CANCELED):
                yield GenOut(f'error: {out.status.name}', self.steps[key],
                             len(input_ids), 0, 'stop')
                return
            tokens = out.num_generated
            if not stream_response and not out.finished:
                continue
            text = self.tokenizer.decode(out.token_ids, offset=response_size)
            # a multi-byte UTF-8 char split across byte-fallback tokens
            # decodes to a trailing replacement char mid-stream; hold the
            # frame until the char completes so clients never see '�'
            # flicker (beyond-reference: the reference emits it,
            # async_engine.py:141-147)
            if not out.finished and text.endswith('�'):
                continue
            new_ids = list(out.token_ids[response_size:])
            new_lps = (list(out.logprobs[response_size:])
                       if (output_logprobs or top_logprobs)
                       and out.logprobs else None)
            new_tops = (list(out.top_logprobs[response_size:])
                        if top_logprobs and out.top_logprobs else None)
            response_size = tokens
            if out.finished:
                finish_reason = ('stop' if out.status == ResponseType.FINISH
                                 and tokens < request_output_len
                                 else 'length'
                                 if tokens >= request_output_len else 'cancel')
            yield GenOut(text, self.steps[key], len(input_ids), tokens,
                         finish_reason, token_ids=new_ids, logprobs=new_lps,
                         top_logprobs=new_tops)
        self.steps[key] += len(input_ids) + tokens
        if sequence_end:
            self.steps[key] = 0

    async def generate_openai(
        self,
        messages: Union[str, List],
        session_id: int,
        stream_response: bool = True,
        renew_session: bool = False,
        request_output_len: int = 512,
        stop: bool = False,
        top_k: int = 40,
        top_p: float = 0.8,
        temperature: float = 0.8,
        repetition_penalty: float = 1.0,
        ignore_eos: bool = False,
        stop_strings: Optional[Union[str, List[str]]] = None,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        output_logprobs: bool = False,
        top_logprobs: int = 0,
    ):
        """OpenAI-flavored generate: session continues until renew_session
        (reference: async_engine.py:154)."""
        key = str(session_id)
        if renew_session:
            self.end_session(session_id)
        if key not in self.steps:
            self.steps[key] = 0
        sequence_start = self.steps[key] == 0
        async for out in self.generate(
                messages, session_id, stream_response=stream_response,
                sequence_start=sequence_start, sequence_end=False,
                request_output_len=request_output_len, stop=stop,
                top_k=top_k, top_p=top_p, temperature=temperature,
                repetition_penalty=repetition_penalty,
                ignore_eos=ignore_eos, stop_strings=stop_strings,
                presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty,
                output_logprobs=output_logprobs,
                top_logprobs=top_logprobs):
            yield out

    def shutdown(self):
        self.engine.shutdown()


__all__ = ['AsyncEngine']
