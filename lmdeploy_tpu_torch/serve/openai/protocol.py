"""OpenAI API protocol models, as dataclasses.

Port of ``lmdeploy_tpu/serve/openai/protocol.py`` (reference:
lmdeploy/serve/openai/protocol.py) without pydantic: the same models,
field names, defaults and ``model_dump()`` output.  A request model's
:meth:`_Model.from_dict` validates a parsed JSON body as pydantic's lax
mode does: a value must have its field's type or one it converts from
without loss (``1`` for a float, ``"2"`` or ``2.0`` for an int,
``"true"`` / ``1`` for a bool; a string accepts only a string); a union
takes the first member that matches exactly, else the first that
converts; a required field must be present; unknown fields are ignored.
A body that fails raises :class:`ValidationError`, which the server turns
into HTTP 400.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import time
import typing
import uuid
from typing import Any, Dict, List, Literal, Optional, Union


class ValidationError(ValueError):
    """A request body that its model rejects."""


def _gen_id(prefix: str) -> str:
    return f'{prefix}{uuid.uuid4().hex[:22]}'


def _now() -> int:
    return int(time.time())


_BOOL_STRINGS = {'0': False, 'off': False, 'f': False, 'false': False,
                 'n': False, 'no': False, '1': True, 'on': True, 't': True,
                 'true': True, 'y': True, 'yes': True}
_INT_STRING = re.compile(r'\s*[+-]?\d+(_\d+)*(\.0+)?\s*')


def _coerce(v, tp, where: str):
    """``v`` validated against the annotation ``tp`` (lax mode)."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is Any:
        return v
    if origin is Union:
        if v is None and type(None) in args:
            return None
        members = [a for a in args if a is not type(None)]
        for a in members:                    # an exact match first
            try:
                got = _coerce(v, a, where)
            except ValidationError:
                continue
            if type(got) is type(v) and got == v:
                return got
        for a in members:
            try:
                return _coerce(v, a, where)
            except ValidationError:
                pass
        raise ValidationError(f'{where}: {v!r} matches none of {tp}')
    if origin is list:
        if not isinstance(v, list):
            raise ValidationError(f'{where}: expected a list, got {v!r}')
        return [_coerce(x, args[0], f'{where}[{i}]')
                for i, x in enumerate(v)]
    if origin is dict:
        if not isinstance(v, dict):
            raise ValidationError(f'{where}: expected an object, got {v!r}')
        return {_coerce(k, args[0], where): _coerce(x, args[1],
                                                    f'{where}.{k}')
                for k, x in v.items()}
    if tp is str:
        if isinstance(v, str):
            return v
    elif tp is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _BOOL_STRINGS:
            return _BOOL_STRINGS[v.lower()]
    elif tp is int:
        if isinstance(v, int):
            return int(v)
        if isinstance(v, float) and math.isfinite(v) and v == int(v):
            return int(v)
        if isinstance(v, str) and _INT_STRING.fullmatch(v):
            return int(float(v))
    elif tp is float:
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                pass
    raise ValidationError(f'{where}: {v!r} is not a valid {tp}')


class _Model:
    """Shared methods of the dataclass models."""

    @classmethod
    def from_dict(cls, body):
        """The model of a parsed JSON body; raises ValidationError."""
        if not isinstance(body, dict):
            raise ValidationError(f'{cls.__name__}: the body must be a JSON '
                                  f'object, got {type(body).__name__}')
        hints = typing.get_type_hints(cls)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in body:
                kw[f.name] = _coerce(body[f.name], hints[f.name],
                                     f'{cls.__name__}.{f.name}')
            elif f.default is dataclasses.MISSING and \
                    f.default_factory is dataclasses.MISSING:
                raise ValidationError(f'{cls.__name__}.{f.name}: field '
                                      'required')
        return cls(**kw)

    def model_dump(self) -> dict:
        return dataclasses.asdict(self)

    def model_dump_json(self) -> str:
        return json.dumps(self.model_dump(), ensure_ascii=False,
                          separators=(',', ':'))


@dataclasses.dataclass(kw_only=True)
class ErrorResponse(_Model):
    object: str = 'error'
    message: str
    code: int


@dataclasses.dataclass(kw_only=True)
class ModelPermission(_Model):
    id: str = dataclasses.field(
        default_factory=lambda: _gen_id('modelperm-'))
    object: str = 'model_permission'
    created: int = dataclasses.field(default_factory=_now)
    allow_create_engine: bool = False
    allow_sampling: bool = True
    allow_logprobs: bool = True
    allow_search_indices: bool = True
    allow_view: bool = True
    allow_fine_tuning: bool = False
    organization: str = '*'
    group: Optional[str] = None
    is_blocking: bool = False


@dataclasses.dataclass(kw_only=True)
class ModelCard(_Model):
    id: str
    object: str = 'model'
    created: int = dataclasses.field(default_factory=_now)
    owned_by: str = 'lmdeploy-tpu'
    root: Optional[str] = None
    parent: Optional[str] = None
    permission: List[ModelPermission] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass(kw_only=True)
class ModelList(_Model):
    object: str = 'list'
    data: List[ModelCard] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(kw_only=True)
class UsageInfo(_Model):
    prompt_tokens: int = 0
    total_tokens: int = 0
    completion_tokens: Optional[int] = 0


@dataclasses.dataclass(kw_only=True)
class ChatCompletionRequest(_Model):
    model: str
    messages: Union[str, List[Dict[str, str]]]
    temperature: Optional[float] = 0.7
    top_p: Optional[float] = 1.0
    n: Optional[int] = 1
    max_tokens: Optional[int] = 512
    # bool = interrupt the session (lmdeploy extension); str / list of
    # str = OpenAI stop strings, expanded to stop token sequences
    stop: Optional[Union[bool, str, List[str]]] = False
    stream: Optional[bool] = False
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    user: Optional[str] = None
    # additional parameters supported by lmdeploy
    repetition_penalty: Optional[float] = 1.0
    renew_session: Optional[bool] = False
    ignore_eos: Optional[bool] = False
    # top_k=1 requests greedy decoding (lmdeploy-tpu extension)
    top_k: Optional[int] = 40
    # OpenAI chat logprobs; top_logprobs 0-5 alternatives per token
    logprobs: Optional[bool] = False
    top_logprobs: Optional[int] = None


@dataclasses.dataclass(kw_only=True)
class ChatMessage(_Model):
    role: str
    content: str


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponseChoice(_Model):
    index: int
    message: ChatMessage
    finish_reason: Optional[Literal['stop', 'length']] = None
    logprobs: Optional[Any] = None       # {'content': [...]} OpenAI shape


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponse(_Model):
    id: str = dataclasses.field(default_factory=lambda: _gen_id('chatcmpl-'))
    object: str = 'chat.completion'
    created: int = dataclasses.field(default_factory=_now)
    model: str
    choices: List[ChatCompletionResponseChoice]
    usage: UsageInfo


@dataclasses.dataclass(kw_only=True)
class DeltaMessage(_Model):
    role: Optional[str] = None
    content: Optional[str] = None


@dataclasses.dataclass(kw_only=True)
class ChatCompletionResponseStreamChoice(_Model):
    index: int
    delta: DeltaMessage
    finish_reason: Optional[Literal['stop', 'length']] = None
    logprobs: Optional[Any] = None       # {'content': [...]} OpenAI shape


@dataclasses.dataclass(kw_only=True)
class ChatCompletionStreamResponse(_Model):
    id: str = dataclasses.field(default_factory=lambda: _gen_id('chatcmpl-'))
    object: str = 'chat.completion.chunk'
    created: int = dataclasses.field(default_factory=_now)
    model: str
    choices: List[ChatCompletionResponseStreamChoice]


@dataclasses.dataclass(kw_only=True)
class CompletionRequest(_Model):
    model: str
    prompt: Union[str, List[str]]
    suffix: Optional[str] = None
    temperature: Optional[float] = 0.7
    n: Optional[int] = 1
    max_tokens: Optional[int] = 16
    # bool = interrupt the session; str / list of str = stop strings
    stop: Optional[Union[bool, str, List[str]]] = False
    stream: Optional[bool] = False
    top_p: Optional[float] = 1.0
    logprobs: Optional[int] = None
    echo: Optional[bool] = False
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    user: Optional[str] = None
    repetition_penalty: Optional[float] = 1.0
    ignore_eos: Optional[bool] = False
    top_k: Optional[int] = 40


@dataclasses.dataclass(kw_only=True)
class CompletionResponseChoice(_Model):
    index: int
    text: str
    logprobs: Optional[Any] = None
    finish_reason: Optional[Literal['stop', 'length']] = None


@dataclasses.dataclass(kw_only=True)
class CompletionResponse(_Model):
    id: str = dataclasses.field(default_factory=lambda: _gen_id('cmpl-'))
    object: str = 'text_completion'
    created: int = dataclasses.field(default_factory=_now)
    model: str
    choices: List[CompletionResponseChoice]
    usage: UsageInfo


@dataclasses.dataclass(kw_only=True)
class CompletionResponseStreamChoice(_Model):
    index: int
    text: str
    logprobs: Optional[Any] = None
    finish_reason: Optional[Literal['stop', 'length']] = None


@dataclasses.dataclass(kw_only=True)
class CompletionStreamResponse(_Model):
    id: str = dataclasses.field(default_factory=lambda: _gen_id('cmpl-'))
    object: str = 'text_completion'
    created: int = dataclasses.field(default_factory=_now)
    model: str
    choices: List[CompletionResponseStreamChoice]


@dataclasses.dataclass(kw_only=True)
class EmbeddingsRequest(_Model):
    model: Optional[str] = None
    input: Union[str, List[str]]
    user: Optional[str] = None


@dataclasses.dataclass(kw_only=True)
class EmbeddingsResponse(_Model):
    object: str = 'list'
    data: List[Dict[str, Any]]
    model: str
    usage: UsageInfo


@dataclasses.dataclass(kw_only=True)
class GenerateRequest(_Model):
    prompt: Union[str, List[Dict[str, str]]]
    instance_id: int = -1
    sequence_start: bool = True
    sequence_end: bool = False
    stream: bool = False
    stop: bool = False
    request_output_len: int = 512
    top_p: float = 0.8
    top_k: int = 40
    temperature: float = 0.8
    repetition_penalty: float = 1.0
    ignore_eos: bool = False


@dataclasses.dataclass(kw_only=True)
class GenerateResponse(_Model):
    text: str
    tokens: int
    finish_reason: Optional[Literal['stop', 'length', 'cancel']] = None


__all__ = ['ValidationError', 'ErrorResponse', 'ModelPermission',
           'ModelCard', 'ModelList', 'UsageInfo', 'ChatCompletionRequest',
           'ChatMessage', 'ChatCompletionResponseChoice',
           'ChatCompletionResponse', 'DeltaMessage',
           'ChatCompletionResponseStreamChoice',
           'ChatCompletionStreamResponse', 'CompletionRequest',
           'CompletionResponseChoice', 'CompletionResponse',
           'CompletionResponseStreamChoice', 'CompletionStreamResponse',
           'EmbeddingsRequest', 'EmbeddingsResponse', 'GenerateRequest',
           'GenerateResponse']
