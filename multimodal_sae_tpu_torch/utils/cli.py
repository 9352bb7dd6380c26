"""Dataclass → argparse bridge (a copy of multimodal_sae_tpu/utils/cli.py, so
both packages' CLIs take the same flags).

The reference parses its config dataclasses with `simple_parsing`; this
module provides the small subset we need: flags named after fields
(underscores → dashes accepted too), positional fields via
`metadata={"positional": True}`, nested dataclasses flattened
(`--k`, `--expansion_factor` style, like simple_parsing's default), bools as
`--flag` / `--no-flag` pairs, and lists as nargs="*".  A field's
`metadata["help"]`, where it has one, is its help text.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Any, Optional, Sequence, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _unwrap_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _field_doc(cls, f: dataclasses.Field) -> str:
    # Dataclasses don't retain per-field docstrings; keep help minimal.
    return f.metadata.get("help") or f.name.replace("_", " ")


def add_dataclass_args(
    parser: argparse.ArgumentParser, cls: Type, prefix: str = ""
) -> None:
    """Register the fields of dataclass `cls` as argparse arguments."""
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        tp = _unwrap_optional(f.type if not isinstance(f.type, str) else _resolve(cls, f.type))
        name = f.name
        if dataclasses.is_dataclass(tp):
            add_dataclass_args(parser, tp, prefix=prefix)
            continue

        positional = f.metadata.get("positional", False)
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        )

        if positional:
            parser.add_argument(name, nargs="?", default=default, help=_field_doc(cls, f))
            continue

        # Register both spellings (argparse does not treat - and _ as
        # interchangeable): --expansion_factor and --expansion-factor.
        dashed = f"--{name.replace('_', '-')}"
        flags = (f"--{name}",) if dashed == f"--{name}" else (f"--{name}", dashed)
        origin = get_origin(tp)
        if tp is bool:
            group = parser.add_mutually_exclusive_group()
            group.add_argument(
                *flags, dest=name, action="store_true", default=default, help=_field_doc(cls, f)
            )
            group.add_argument(
                f"--no-{name.replace('_', '-')}",
                f"--no_{name}",
                dest=name,
                action="store_false",
            )
        elif origin in (list, typing.List) or tp in (list,):
            elem = (get_args(tp) or (str,))[0]
            parser.add_argument(*flags, dest=name, nargs="*", type=elem, default=default)
        elif tp in (int, float, str):
            parser.add_argument(*flags, dest=name, type=tp, default=default)
        elif get_origin(tp) is typing.Literal:
            choices = get_args(tp)
            # argv tokens are strings: convert through the member type so
            # non-string Literals (e.g. Literal[64, 128]) remain matchable.
            conv = type(choices[0]) if choices and not isinstance(choices[0], str) else None
            parser.add_argument(
                *flags, dest=name, choices=choices, default=default, type=conv
            )
        else:
            # Fallback: parse as string.
            parser.add_argument(*flags, dest=name, type=str, default=default)


def _resolve(cls, annotation: str):
    """Resolve a string annotation in the module namespace of `cls`."""
    import sys

    mod = sys.modules.get(cls.__module__)
    ns = dict(vars(typing))
    if mod is not None:
        ns.update(vars(mod))
    try:
        return eval(annotation, ns)  # noqa: S307 - controlled input (our own configs)
    except Exception:
        return str


def dataclass_from_namespace(cls: Type[T], ns: argparse.Namespace) -> T:
    """Construct dataclass `cls` (recursively) from parsed args."""
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        tp = _unwrap_optional(f.type if not isinstance(f.type, str) else _resolve(cls, f.type))
        if dataclasses.is_dataclass(tp):
            kwargs[f.name] = dataclass_from_namespace(tp, ns)
        elif hasattr(ns, f.name):
            kwargs[f.name] = getattr(ns, f.name)
    return cls(**kwargs)


def parse_dataclass(
    cls: Type[T], args: Optional[Sequence[str]] = None, description: str = ""
) -> T:
    """Parse argv into an instance of dataclass `cls`."""
    parser = argparse.ArgumentParser(description=description or cls.__name__)
    add_dataclass_args(parser, cls)
    ns = parser.parse_args(args)
    return dataclass_from_namespace(cls, ns)
