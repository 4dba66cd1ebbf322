"""
Strict dict -> (nested) dataclass decoding for JSON API requests: the port's
own copy of riffusion_tpu/util/dataclass_util.py.

Raises DecodeError with a useful message on unknown fields, missing required
fields, or type mismatches; the server maps these to HTTP 400.
"""

from __future__ import annotations

import dataclasses
import typing as T


class DecodeError(Exception):
    """Raised when a dict cannot be decoded into the target dataclass."""


def from_dict(cls: type, data: T.Any, path: str = "$") -> T.Any:
    """Decode `data` into dataclass `cls`, recursing into nested dataclasses."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    if not isinstance(data, dict):
        raise DecodeError(f"{path}: expected an object for {cls.__name__}, got {type(data).__name__}")

    hints = T.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise DecodeError(f"{path}: unknown field(s) {sorted(unknown)} for {cls.__name__}")

    kwargs = {}
    for f in dataclasses.fields(cls):
        key_path = f"{path}.{f.name}"
        if f.name in data:
            kwargs[f.name] = _coerce(hints[f.name], data[f.name], key_path)
        elif f.default is not dataclasses.MISSING or f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            continue
        else:
            raise DecodeError(f"{key_path}: missing required field")
    return cls(**kwargs)


def _coerce(hint: T.Any, value: T.Any, path: str) -> T.Any:
    origin = T.get_origin(hint)
    if origin is T.Union:
        args = [a for a in T.get_args(hint) if a is not type(None)]
        if value is None:
            if type(None) in T.get_args(hint):
                return None
            raise DecodeError(f"{path}: null not allowed")
        errors = []
        for a in args:
            try:
                return _coerce(a, value, path)
            except DecodeError as e:
                errors.append(str(e))
        raise DecodeError(f"{path}: no Union arm matched ({'; '.join(errors)})")
    if origin in (list, T.List):
        (item_type,) = T.get_args(hint) or (T.Any,)
        if not isinstance(value, list):
            raise DecodeError(f"{path}: expected list, got {type(value).__name__}")
        return [_coerce(item_type, v, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (dict, T.Dict):
        return dict(value)
    if dataclasses.is_dataclass(hint):
        return from_dict(hint, value, path)
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DecodeError(f"{path}: expected number, got {type(value).__name__}")
        return float(value)
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise DecodeError(f"{path}: expected int, got {type(value).__name__}")
        return value
    if hint is bool:
        if not isinstance(value, bool):
            raise DecodeError(f"{path}: expected bool, got {type(value).__name__}")
        return value
    if hint is str:
        if not isinstance(value, str):
            raise DecodeError(f"{path}: expected string, got {type(value).__name__}")
        return value
    return value
