"""Dataclass-based hierarchical config with CLI override.

TPU-native replacement for Kaldi's three-tier flag system
(ref: src/util/parse-options.{h,cc} ``ParseOptions::Register``,
utils/parse_options.sh, conf/*.conf).  Option *names* mirror the
reference where parity matters (``beam``, ``lattice_beam``,
``acoustic_scale``, ``num_mel_bins``, splice context, ...) so recipe
configs translate 1:1.

Usage::

    @configclass
    class FbankOptions:
        samp_freq: float = 16000.0
        num_mel_bins: int = 23

    opts = parse_cli(FbankOptions, ["--num-mel-bins=40"])
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Sequence, Type, TypeVar, get_type_hints

T = TypeVar("T")


def configclass(cls: Type[T]) -> Type[T]:
    """Decorator: a plain dataclass usable as a config node.

    Nested configclasses are supported; CLI flags address leaves with
    dotted (or dashed) paths: ``--frame-opts.frame-shift-ms=10``.
    """
    return dataclasses.dataclass(cls)


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool or typ == "bool":
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if typ is int or typ == "int":
        return int(value)
    if typ is float or typ == "float":
        return float(value)
    if typ is str or typ == "str":
        return value
    # Lists and anything else: JSON
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def _set_dotted(obj: Any, path: List[str], value: str) -> None:
    if not dataclasses.is_dataclass(obj):
        raise KeyError(f"not a config node at {'.'.join(path)}")
    name = path[0].replace("-", "_")
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if name not in fields:
        raise KeyError(
            f"unknown option {name!r}; known: {sorted(fields)}")
    if len(path) == 1:
        hints = get_type_hints(type(obj))
        typ = hints.get(name, str)
        cur = getattr(obj, name)
        if dataclasses.is_dataclass(cur):
            raise KeyError(f"{name} is a config group, not a leaf")
        setattr(obj, name, _coerce(value, typ) if isinstance(value, str) else value)
    else:
        _set_dotted(getattr(obj, name), path[1:], value)


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Apply ``--a.b=v`` / ``--a-b v`` style overrides in place."""
    i = 0
    items: List[tuple] = []
    overrides = list(overrides)
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --option, got {tok!r}")
        tok = tok[2:]
        if "=" in tok:
            key, value = tok.split("=", 1)
            i += 1
        else:
            key = tok
            if i + 1 >= len(overrides):
                raise ValueError(f"missing value for --{key}")
            value = overrides[i + 1]
            i += 2
        items.append((key, value))
    for key, value in items:
        if key == "config":
            with open(value) as f:
                file_args = [ln.strip() for ln in f
                             if ln.strip() and not ln.startswith("#")]
            apply_overrides(cfg, file_args)
        else:
            _set_dotted(cfg, key.split("."), value)
    return cfg


def parse_cli(cls: Type[T], argv: Sequence[str]) -> T:
    """Construct ``cls()`` with defaults, then apply CLI overrides."""
    cfg = cls()
    return apply_overrides(cfg, argv)


def asdict_flat(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a (nested) configclass to {dotted.name: leaf}."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(asdict_flat(v, key + "."))
        else:
            out[key] = v
    return out
