"""Chat-template registry.

Copy of ``lmdeploy_tpu/model.py`` (no JAX in it; the port imports nothing
of the JAX package).  Behavior-parity rebuild of the reference template
registry (reference: lmdeploy/model.py — MODELS registry,
BaseModel.get_prompt / messages2prompt / stop_words / sampling defaults).  Templates turn a raw
user prompt (or an OpenAI-style message list) into the exact string a
given chat model was trained on, and carry per-model sampling defaults,
session lengths and stop-word ids.

The literal ``<BOS>`` marker means "the tokenizer should prepend the BOS
token here"; it is consumed by
:class:`lmdeploy_tpu_torch.tokenizer.Tokenizer`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

Messages = Union[str, List[dict]]


@dataclasses.dataclass
class SamplingParam:
    """Per-model sampling defaults (reference: lmdeploy/model.py:12-16)."""
    top_p: float = 0.8
    top_k: Optional[int] = None
    temperature: float = 0.8
    repetition_penalty: float = 1.0


class _Registry:
    """Tiny name->class registry (replaces the reference's mmengine Registry)."""

    def __init__(self) -> None:
        self.module_dict: Dict[str, type] = {}

    def register(self, *names: str) -> Callable[[type], type]:
        def deco(cls: type) -> type:
            for name in names:
                self.module_dict[name] = cls
            return cls

        return deco

    def get(self, name: str) -> Optional[type]:
        return self.module_dict.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.module_dict


MODELS = _Registry()


def split_messages(messages: List[dict]):
    """Split a chat history into (system, users, assistants) with a trailing
    ``None`` assistant slot for the turn being generated
    (reference: BaseModel._translate_messages)."""
    system = None
    users: List[str] = []
    assistants: List[Optional[str]] = []
    for message in messages:
        role = message['role']
        if role == 'system':
            system = message['content']
        elif role == 'user':
            users.append(message['content'])
        elif role == 'assistant':
            assistants.append(message['content'])
        else:
            raise ValueError(f'Unknown role: {role}')
    assistants.append(None)
    return system, users, assistants


@MODELS.register('base', 'llama', 'internlm')
class BaseModel:
    """Plain completion model: the prompt passes through untouched."""

    def __init__(self,
                 session_len: int = 2048,
                 top_p: float = 0.8,
                 top_k: Optional[int] = None,
                 temperature: float = 0.8,
                 repetition_penalty: float = 1.0,
                 capability: str = 'chat',
                 **kwargs):
        self.session_len = session_len
        self.top_p = top_p
        self.top_k = top_k
        self.temperature = temperature
        self.repetition_penalty = repetition_penalty
        self.capability = capability

    # -- prompt construction -------------------------------------------------
    def decorate_prompt(self, prompt: str, sequence_start: bool = True) -> str:
        return prompt

    def get_prompt(self, prompt: str, sequence_start: bool = True) -> str:
        if self.capability == 'completion':
            return prompt
        return self.decorate_prompt(prompt, sequence_start)

    def messages2prompt(self, messages: Messages, sequence_start: bool = True) -> str:
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        # Generic transcript fallback for templates without a chat-history
        # format.  (The reference BaseModel returns None here — "chat
        # history processing in derived classes", lmdeploy/model.py:100-102
        # — which crashes downstream; degrade gracefully instead so plain
        # workspaces still serve /v1/chat/completions.)
        parts = [f"{m['role']}: {m['content']}" for m in messages]
        return self.get_prompt('\n'.join(parts) + '\nassistant: ',
                               sequence_start)

    # -- metadata -------------------------------------------------------------
    @property
    def stop_words(self) -> Optional[List[int]]:
        return None

    @property
    def sampling_param(self) -> SamplingParam:
        return SamplingParam(top_p=self.top_p,
                             top_k=self.top_k,
                             temperature=self.temperature,
                             repetition_penalty=self.repetition_penalty)

    def _require_chat(self):
        if self.capability != 'chat':
            raise AssertionError(
                f'{type(self).__name__} has no capability of {self.capability}')


@MODELS.register('vicuna')
class Vicuna(BaseModel):
    """Vicuna dialog format: ``{system} USER: .. ASSISTANT: ..</s>``."""

    DEFAULT_SYSTEM = ('A chat between a curious user and an artificial '
                      'intelligence assistant. The assistant gives helpful, '
                      "detailed, and polite answers to the user's questions. ")

    def __init__(self, system: str = DEFAULT_SYSTEM, user: str = 'USER',
                 assistant: str = 'ASSISTANT', **kwargs):
        super().__init__(**kwargs)
        self.system = system
        self.user = user
        self.assistant = assistant

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        if sequence_start:
            return f'{self.system} {self.user}: {prompt} {self.assistant}: '
        return f'</s>{self.user}: {prompt} {self.assistant}: '

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        system, users, assistants = split_messages(messages)
        out = [(system or self.system) + ' ']
        for user, assistant in zip(users, assistants):
            if assistant:
                out.append(f'{self.user}: {user} {self.assistant}: {assistant}</s>')
            else:
                out.append(f'{self.user}: {user} {self.assistant}: ')
        return ''.join(out)


@MODELS.register('internlm-chat', 'internlm-chat-7b')
class InternLMChat7B(BaseModel):
    """InternLM dialog format with ``<|User|>`` / ``<|Bot|>`` / ``<eoa>``."""

    def __init__(self, system: str = '', user: str = '<|User|>', eoh: str = '',
                 eoa: str = '<eoa>', assistant: str = '<|Bot|>', **kwargs):
        super().__init__(**kwargs)
        self.system = system
        self.user = user
        self.eoh = eoh
        self.eoa = eoa
        self.assistant = assistant

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        lead = '<BOS>' if sequence_start else '\n'
        return f'{lead}{self.user}:{prompt}{self.eoh}\n{self.assistant}:'

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        _, users, assistants = split_messages(messages)
        out = ['<BOS>']
        for user, assistant in zip(users, assistants):
            out.append(f'{self.user}:{user}{self.eoh}\n{self.assistant}:')
            if assistant:
                out.append(f'{assistant}{self.eoa}\n')
        return ''.join(out)

    @property
    def stop_words(self):
        return [103028]  # <eoa>


@MODELS.register('internlm-chat-7b-8k', 'internlm-chat-20b')
class InternLMChat7B8K(InternLMChat7B):
    def __init__(self, session_len: int = 8192, **kwargs):
        kwargs.pop('session_len', None)
        super().__init__(session_len=session_len, **kwargs)


@MODELS.register('internlm-20b')
class InternLMBase20B(BaseModel):
    def __init__(self, session_len: int = 4096, capability: str = 'completion',
                 **kwargs):
        kwargs.pop('session_len', None)
        kwargs.pop('capability', None)
        super().__init__(session_len=session_len, capability=capability, **kwargs)


@MODELS.register('baichuan-7b')
class Baichuan7B(BaseModel):
    def __init__(self, repetition_penalty: float = 1.1, **kwargs):
        kwargs.pop('repetition_penalty', None)
        super().__init__(repetition_penalty=repetition_penalty, **kwargs)


@MODELS.register('baichuan2-7b')
class Baichuan2_7B(BaseModel):
    """Baichuan2 chat format: reserved tokens 195/196 delimit turns."""

    def __init__(self, temperature: float = 0.3, top_k: int = 5,
                 top_p: float = 0.85, repetition_penalty: float = 1.05, **kwargs):
        for k in ('temperature', 'top_k', 'top_p', 'repetition_penalty'):
            kwargs.pop(k, None)
        super().__init__(temperature=temperature, top_k=top_k, top_p=top_p,
                         repetition_penalty=repetition_penalty, **kwargs)
        self.user_token = '<reserved_106>'  # id = 195
        self.assistant_token = '<reserved_107>'  # id = 196

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        return f'{self.user_token}{prompt}{self.assistant_token}'

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        _, users, assistants = split_messages(messages)
        out = []
        for user, assistant in zip(users, assistants):
            out.append(f'{self.user_token}{user}{self.assistant_token}')
            if assistant:
                out.append(assistant)
        return ''.join(out)


@MODELS.register('puyu')
class Puyu(BaseModel):
    """Puyu internal dialog format (reference: lmdeploy/model.py:322)."""

    def __init__(self, meta_instruction: str = '', system: str = '',
                 eosys: str = '', user: str = '', eoh: str = '',
                 assistant: str = '', eoa: str = '', **kwargs):
        super().__init__(**kwargs)
        self.meta_instruction = meta_instruction
        self.system = system
        self.eosys = eosys
        self.user = user
        self.eoh = eoh
        self.assistant = assistant
        self.eoa = eoa

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        if sequence_start:
            return (f'<BOS>{self.system}{self.meta_instruction}{self.eosys}'
                    f'{self.user}{prompt}{self.eoh}{self.assistant}')
        return f'{self.eoa}{self.user}{prompt}{self.eoh}{self.assistant}'

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        system, users, assistants = split_messages(messages)
        system = system or self.system
        out = [f'<BOS>{system}{self.meta_instruction}{self.eosys}']
        for user, assistant in zip(users, assistants):
            out.append(f'{self.user}{user}{self.eoh}{self.assistant}')
            if assistant:
                out.append(f'{assistant}{self.eoa}')
        return ''.join(out)

    @property
    def stop_words(self):
        return [45623]


@MODELS.register('llama2', 'llama-2', 'llama-2-chat')
class Llama2(BaseModel):
    """Llama-2 chat format: ``[INST] <<SYS>> .. <</SYS>> .. [/INST]``."""

    DEFAULT_SYSTEM = (
        'You are a helpful, respectful and honest assistant. Always answer '
        'as helpfully as possible, while being safe. Your answers should not '
        'include any harmful, unethical, racist, sexist, toxic, dangerous, '
        'or illegal content. Please ensure that your responses are socially '
        'unbiased and positive in nature.\n\nIf a question does not make any '
        'sense, or is not factually coherent, explain why instead of '
        "answering something not correct. If you don't know the answer to a "
        "question, please don't share false information.")

    def __init__(self, b_inst: str = '[INST]', e_inst: str = '[/INST]',
                 b_sys: str = '<<SYS>>\n', e_sys: str = '\n<</SYS>>\n\n',
                 system: str = DEFAULT_SYSTEM, session_len: int = 4096,
                 **kwargs):
        kwargs.pop('session_len', None)
        super().__init__(session_len=session_len, **kwargs)
        self.b_inst = b_inst
        self.e_inst = e_inst
        self.b_sys = b_sys
        self.e_sys = e_sys
        self.default_sys_prompt = system

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        if sequence_start:
            return (f'<BOS>{self.b_inst} {self.b_sys} '
                    f'{self.default_sys_prompt} {self.e_sys}'
                    f'{prompt} {self.e_inst} ')
        return f'{self.b_inst} {prompt} {self.e_inst} '

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        system, users, assistants = split_messages(messages)
        system = system or self.default_sys_prompt
        out = [f'<BOS>{self.b_inst} {self.b_sys} {system} {self.e_sys}']
        for i, (user, assistant) in enumerate(zip(users, assistants)):
            if i != 0:
                out.append(f'{self.b_inst} ')
            if assistant:
                out.append(f'{user} {self.e_inst} {assistant}')
            else:
                out.append(f'{user} {self.e_inst} ')
        return ''.join(out)


@MODELS.register('qwen-7b', 'qwen-14b')
class Qwen7BChat(BaseModel):
    """Qwen ChatML format: ``<|im_start|>role\\n..<|im_end|>``."""

    def __init__(self, session_len: int = 8192, top_p: float = 0.5,
                 top_k: int = 40, temperature: float = 1.0,
                 im_start: str = '<|im_start|>', im_end: str = '<|im_end|>',
                 system: str = 'You are a helpful assistant.', **kwargs):
        for k in ('session_len', 'top_p', 'top_k', 'temperature'):
            kwargs.pop(k, None)
        super().__init__(session_len=session_len, top_p=top_p, top_k=top_k,
                         temperature=temperature, **kwargs)
        self.im_start = im_start
        self.im_end = im_end
        self.system = system

    def decorate_prompt(self, prompt, sequence_start=True):
        self._require_chat()
        body = (f'\n{self.im_start}user\n{prompt}{self.im_end}'
                f'\n{self.im_start}assistant\n')
        if sequence_start:
            return f'{self.im_start}system\n{self.system}{self.im_end}' + body
        return body

    def messages2prompt(self, messages, sequence_start=True):
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        system, users, assistants = split_messages(messages)
        system = system or self.system
        out = [f'{self.im_start}system\n{system}{self.im_end}']
        for user, assistant in zip(users, assistants):
            out.append(f'\n{self.im_start}user\n{user}{self.im_end}'
                       f'\n{self.im_start}assistant\n')
            if assistant:
                out.append(assistant)
        return ''.join(out)

    @property
    def stop_words(self):
        return [151645]  # <|im_end|>


@MODELS.register('codellama')
class CodeLlama(Llama2):
    """Code Llama: completion / infilling / chat / python capabilities
    (reference: lmdeploy/model.py:515-588)."""

    CAPS = ('completion', 'infilling', 'chat', 'python')

    def __init__(self, system: str = '', session_len: int = 4096,
                 suffix_first: bool = False, **kwargs):
        kwargs.pop('session_len', None)
        super().__init__(session_len=session_len, **kwargs)
        if self.capability not in self.CAPS:
            raise AssertionError(
                f'{self.capability} is not supported. '
                f'The supported capabilities are: {list(self.CAPS)}')
        self.default_sys_prompt = system
        self.suffix_first = suffix_first
        # Sampling defaults follow the upstream codellama release.
        if self.capability in ('completion', 'python'):
            self.top_p = kwargs.get('top_p', 0.9)
            self.temperature = kwargs.get('temperature', 0.2)
        elif self.capability == 'chat':
            self.top_p = kwargs.get('top_p', 0.95)
            self.temperature = kwargs.get('temperature', 0.2)
        elif self.capability == 'infilling':
            self.top_p = kwargs.get('top_p', 0.9)
            self.temperature = kwargs.get('temperature', 0.0)

    def decorate_prompt(self, prompt, sequence_start=True):
        if self.capability == 'infilling':
            return self._infill_prompt(prompt)
        if self.capability == 'chat':
            return self._chat_prompt(prompt, sequence_start)
        return prompt

    def _infill_prompt(self, prompt: str) -> str:
        prefix, suffix = prompt.split('<FILL>')
        if self.suffix_first:
            return f'<BOS><PRE> <SUF>{suffix} <MID> {prefix}'
        return f'<BOS><PRE> {prefix} <SUF>{suffix} <MID>'

    def _chat_prompt(self, prompt: str, sequence_start: bool) -> str:
        prompt = prompt.strip()
        if sequence_start:
            return (f'<BOS>{self.b_inst} '
                    f'{self.b_sys}{self.default_sys_prompt}{self.e_sys}'
                    f'{prompt} {self.e_inst}')
        return f'{self.b_inst} {prompt} {self.e_inst}'

    @property
    def stop_words(self):
        if self.capability == 'infilling':
            return [32010]  # <EOT>
        return None

    def messages2prompt(self, messages, sequence_start=True):
        if self.capability != 'chat':
            raise AssertionError(
                'codellama messages2prompt only supports chat mode '
                f'but got {self.capability} mode')
        return super().messages2prompt(messages, sequence_start)


def best_match_model(model_path: str) -> Optional[str]:
    """Heuristically map a checkpoint path to a registered template name."""
    name = model_path.lower().rstrip('/').split('/')[-1]
    patterns = [
        ('codellama', 'codellama'),
        ('llama-2', 'llama2'), ('llama2', 'llama2'),
        ('internlm-chat-7b-8k', 'internlm-chat-7b-8k'),
        ('internlm-chat-20b', 'internlm-chat-20b'),
        ('internlm-chat', 'internlm-chat'),
        ('internlm-20b', 'internlm-20b'),
        ('internlm', 'internlm'),
        ('baichuan2', 'baichuan2-7b'), ('baichuan', 'baichuan-7b'),
        ('qwen', 'qwen-7b'), ('vicuna', 'vicuna'),
        ('puyu', 'puyu'), ('llama', 'llama'),
    ]
    for pat, reg in patterns:
        if pat in name:
            return reg
    return None


def main(model_name: str = 'base'):
    if model_name not in MODELS.module_dict:
        raise SystemExit(f"'{model_name}' is not supported. Supported: "
                         f'{sorted(MODELS.module_dict)}')
    model = MODELS.get(model_name)()
    print(model.get_prompt('hi'))
    print(f'session_len: {model.session_len}')


if __name__ == '__main__':
    import sys
    main(*sys.argv[1:])
