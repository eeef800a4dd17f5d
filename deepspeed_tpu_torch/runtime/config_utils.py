"""Typed-config plumbing.

A copy of ``deepspeed_tpu/runtime/config_utils.py`` (the port imports nothing
of the JAX package): dataclasses with a strict ``from_dict`` that reports
unknown keys — typo detection, defaults, nesting.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Type, TypeVar, get_args, get_origin, get_type_hints

logger = logging.getLogger("deepspeed_tpu_torch")

T = TypeVar("T")


class DeepSpeedConfigError(Exception):
    pass


def config_from_dict(cls: Type[T], data: Dict[str, Any], path: str = "") -> T:
    """Build dataclass ``cls`` from a JSON dict, recursing into nested configs."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise DeepSpeedConfigError(f"config section {path or cls.__name__} must be a "
                                   f"dict, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        if key not in fields:
            logger.warning(f"unknown config key {path + key!r} — ignored")
            continue
        ftype = hints.get(key, fields[key].type)
        origin = get_origin(ftype)
        if origin is None and dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = config_from_dict(ftype, value, path=f"{path}{key}.")
        elif origin is not None and type(None) in get_args(ftype):
            inner = [a for a in get_args(ftype) if a is not type(None)]
            if len(inner) == 1 and dataclasses.is_dataclass(inner[0]) and isinstance(value, dict):
                kwargs[key] = config_from_dict(inner[0], value, path=f"{path}{key}.")
            else:
                kwargs[key] = value
        else:
            kwargs[key] = value
    try:
        obj = cls(**kwargs)
    except TypeError as e:
        raise DeepSpeedConfigError(f"invalid config section {path or cls.__name__}: {e}")
    if hasattr(obj, "validate"):
        obj.validate()
    return obj


def config_to_dict(obj) -> Dict[str, Any]:
    return dataclasses.asdict(obj)


def later_slice(what: str) -> NotImplementedError:
    """The error for an option of the JAX package that this slice of the
    port does not run yet."""
    return NotImplementedError(
        f"{what} is not supported by deepspeed_tpu_torch yet; it comes in a "
        "later slice of the port")
