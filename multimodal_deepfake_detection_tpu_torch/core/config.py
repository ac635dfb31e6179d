"""Dataclass configs with ``--field value`` overrides.

Counterpart of ``multimodal_deepfake_detection_tpu/core/config.py``: each CLI
declares a dataclass whose defaults are the JAX CLI's; any field is
overridable on the command line, booleans as true/false, tuples as
comma-separated lists.
"""
from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _parse_value(field_type, raw: str):
    if field_type in (bool, Optional[bool]):
        return raw.lower() in ("1", "true", "yes", "on")
    for t in (int, float, str):
        if field_type in (t, Optional[t]):
            return t(raw)
    inner = (typing.get_args(field_type) or (str,))[0]
    return tuple(inner(v) for v in raw.split(",") if v)


def parse_config(cls: Type[T], argv: Optional[Sequence[str]] = None, *, prog: str) -> T:
    """``cls()`` with ``--field value`` overrides from ``argv``."""
    parser = argparse.ArgumentParser(prog=prog)
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        parser.add_argument(f"--{f.name}", default=None, metavar=str(f.default),
                            help=f"default: {f.default}")
    ns = parser.parse_args(argv)
    overrides = {
        name: _parse_value(hints[name], raw) for name, raw in vars(ns).items() if raw is not None
    }
    return cls(**overrides)
